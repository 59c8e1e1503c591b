// syrk_lower_f32: C := alpha·A·Aᵀ + beta·C on the lower triangle, in place.
//
// Replaces cholesky_tpu/ops/pallas/syrk.py:syrk_f32 (_syrk_kernel), the
// trailing update A22 -= L21·L21ᵀ of the blocked potrf recursion, B11 +=
// MᴴM of the lauum recursion and the public syrk. The TPU kernel walks a
// scalar-prefetched list of lower tiles and aliases C into its output so
// the strict upper survives; here the strict upper of C is never written.
//
// Contract: A (N x K) and C (N x N) are strided f32 views (A k-fast, as a
// row-major L21, or row-fast, as lauum's transposed Mᴴ); A must not
// overlap C; C is read only when beta != 0. A call repeats bit for bit:
// no float atomics, every sum in a fixed order.
//
// What bounds it on the H100: plain f32 FFMA (TF32 is not f32-accurate),
// N(N+1)K/2 of them over the lower triangle, at best the 67 TFLOP/s
// vector rate: 0.128 ms at N = K = 2048. What bounds a tile of FFMA is
// what feeds it; at the potrf recursion's sizes, how evenly the grid
// fills the card: 136 lower tiles of 128 at 2048 (one each on 132 SMs,
// two on four of them), 36 at 1024, 10 at 512.
//
// Design: the lower 128 x 128 tiles' k-steps (BK = 16 deep), in tile
// order, cut into equal runs of q, one run a block, the tile decoded from
// the run (ct::tri_tile, the Hopper form of scalar prefetch). A tile is
// accumulated on sgemm128.cuh (a cp.async ring, 8 x 8 micro-tiles), A
// staged along its own unit-stride axis by 16-byte copies where it sits
// on the 16-byte grid and by 4-byte copies elsewhere. A block stores a
// tile whose whole depth lies in its run into C (alpha and beta applied,
// its lower part only); a part of a tile goes into the block's slot of
// the workspace P (its first part into slot 0, its last into slot 1: the
// tiles between them are whole), and one more launch sums each split
// tile's parts in k order and applies alpha and beta. The wrapper's plan
// (ops/kernels/syrk.py, launch_plan): from WHOLE_MIN_TILES tiles a run is
// whole tiles; below it the runs are cut for one wave of two blocks an
// SM, so every SM does the same work whatever the number of tiles.
// The A/B behind it (chip_smoke.py at commit eceabea; ms of
// one call, NVIDIA H100 80GB HBM3, 700 W): at n = k = 2048, one block a
// tile 0.496-0.504, a uniform split of each tile's depth in 2 / 4
// 0.423-0.430 / 0.363-0.364, runs for 132 / 264 / 528 blocks 0.340-0.347
// / 0.301-0.307 / 0.322-0.331; at 1024 0.155-0.157, 0.096-0.097 /
// 0.089-0.092, 0.072 / 0.070-0.071 / 0.082-0.083; at 512 0.102, 0.061-0.074 /
// 0.054-0.061, 0.041-0.049 / 0.042-0.043 / 0.050. The 64 x 64 tile of
// sgemm_tile.cuh (the design before this one) with the same cuts: at best
// 0.538 at 2048 and 0.101 at 1024, even at 512 (0.043): it went.
// Diagonal tiles store only their lower triangle.
#include "sgemm128.cuh"
#include "sgemm_tile.cuh"

namespace {

constexpr int NT = ct::t128::NT;   // threads
constexpr int BK = ct::t128::BK;   // a k-step
constexpr int E = ct::t128::BM;    // the tile edge

// C[r][c] = alpha·v + beta·C[r][c] (C read only when beta != 0)
__device__ __forceinline__ void update(float* C, long long sc0,
                                       long long sc1, int r, int c,
                                       float v, float alpha, float beta) {
  float* const p = C + r * sc0 + c * sc1;
  float out = alpha * v;
  if (beta != 0.f) out = fmaf(beta, *p, out);
  *p = out;
}

// The k-steps of a tile (at least one, so that k = 0 still writes beta·C).
__host__ __device__ inline int tile_steps(int K) {
  return K > 0 ? (K + BK - 1) / BK : 1;
}

// One part of tile (r0, c0): k [0, kn) of Aq = A + k0·sa1, into C
// (part == nullptr: the whole depth) or into the slot `part`. KF: A is
// k-fast (sa1 = 1); VEC: A on the 16-byte grid.
template <bool KF, bool VEC>
__device__ __forceinline__ void tile_part(const float* Aq, long long sa0,
                                          long long sa1, int r0, int c0,
                                          int N, int kn, float* C,
                                          long long sc0, long long sc1,
                                          float alpha, float beta,
                                          float* part, float* sm) {
  float acc[8][8] = {};
  ct::t128::tile_xyt<KF, KF, VEC>(Aq, sa0, sa1, r0, N, Aq, sa0, sa1, c0, N,
                                  kn, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = ct::t128::row_of(i);
    if (part) {                    // by 16 bytes
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(part + lr * E + ct::t128::col_of(4 * h)) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      continue;
    }
    if (r0 + lr >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + ct::t128::col_of(j);
      if (c <= r0 + lr)
        update(C, sc0, sc1, r0 + lr, c, acc[i][j], alpha, beta);
    }
  }
}

// A block's run [u0, u1) of the k-steps of the lower tiles, tile by tile.
template <bool KF, bool VEC>
__global__ void __launch_bounds__(NT, 2)
syrk_kernel(const float* __restrict__ A, long long sa0, long long sa1,
            float* C, long long sc0, long long sc1, int N, int K, int q,
            float alpha, float beta, float* P) {
  extern __shared__ __align__(16) float sm[];
  const int nt = (N + E - 1) / E, T = tile_steps(K);
  const long long U = static_cast<long long>(nt) * (nt + 1) / 2 * T;
  long long u = static_cast<long long>(blockIdx.x) * q;
  const long long u1 = min(u + q, U);
  const long long first = u / T;   // the run's first tile
  while (u < u1) {
    const int t = static_cast<int>(u / T), s0 = static_cast<int>(u % T);
    const int s1 = static_cast<int>(
        min(static_cast<long long>(T), s0 + (u1 - u)));
    int ti, tj;
    ct::tri_tile(t, ti, tj);
    float* const part =
        (s0 == 0 && s1 == T)
            ? nullptr
            : P + (2LL * blockIdx.x + (t != first)) * E * E;
    const int k0 = s0 * BK, kn = min(s1 * BK, K) - k0;
    tile_part<KF, VEC>(A + k0 * sa1, sa0, sa1, ti * E, tj * E, N, kn, C, sc0,
                       sc1, alpha, beta, part, sm);
    u += s1 - s0;
  }
}

// The last pass, a block per 1024 elements of a lower tile (blockIdx.x the
// tile): a tile split over the runs of blocks b0 < ... < b1 is the sum of
// their parts in k order, four columns a thread, every part's load in
// flight at once.
__global__ void __launch_bounds__(NT)
syrk_reduce(const float* __restrict__ P, float* C, long long sc0,
            long long sc1, int N, int K, int q, float alpha, float beta) {
  const int t = blockIdx.x, T = tile_steps(K);
  const long long b0 = static_cast<long long>(t) * T / q;
  const long long b1 = (static_cast<long long>(t + 1) * T - 1) / q;
  if (b0 == b1) return;            // whole in one run: stored already
  int ti, tj;
  ct::tri_tile(t, ti, tj);
  const int idx = 4 * (blockIdx.y * NT + threadIdx.x);
  const int r = ti * E + idx / E, c = tj * E + idx % E;
  if (idx >= E * E || r >= N || c > r) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (long long b = b0; b <= b1; ++b) {
    const bool last = t != b * q / T;    // not b's first tile: slot 1
    const float4 p =
        *reinterpret_cast<const float4*>(P + (2 * b + last) * E * E + idx);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j <= r) update(C, sc0, sc1, r, c + j, e[j], alpha, beta);
}

using Kernel = void (*)(const float*, long long, long long, float*,
                        long long, long long, int, int, int, float, float,
                        float*);

template <bool KF>
cudaError_t launch(bool vec, unsigned grid, cudaStream_t stream,
                   void** args) {
  constexpr int bytes =
      ct::t128::smem_floats<KF, KF>() * static_cast<int>(sizeof(float));
  const Kernel k = vec ? syrk_kernel<KF, true> : syrk_kernel<KF, false>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(grid),
                          dim3(NT), args, bytes, stream);
}

}  // namespace

// q k-steps of 16 a block, blocks · q covering the lower tiles' k-steps;
// P: two E x E slots a block, used only when q is not a multiple of a
// tile's k-steps; kfast and vec as the wrapper's launch plan finds A.
CT_EXPORT int ct_syrk_lower_f32(const float* A, long long sa0, long long sa1,
                                float* C, long long sc0, long long sc1,
                                int N, int K, float alpha, float beta, int q,
                                int blocks, int kfast, int vec, float* P,
                                int device, void* stream) {
  const int nt = (N + E - 1) / E, T = tile_steps(K);
  const long long tiles = static_cast<long long>(nt) * (nt + 1) / 2;
  const bool split = q % T != 0;
  if (q < 1 || blocks < 1 ||
      static_cast<long long>(blocks) * q < tiles * T || (split && !P))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  void* args[] = {&A, &sa0, &sa1, &C,    &sc0,  &sc1,
                  &N, &K,   &q,   &alpha, &beta, &P};
  err = kfast ? launch<true>(vec != 0, blocks, s, args)
              : launch<false>(vec != 0, blocks, s, args);
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), E * E / (4 * NT));
  syrk_reduce<<<grid, NT, 0, s>>>(P, C, sc0, sc1, N, K, q, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
