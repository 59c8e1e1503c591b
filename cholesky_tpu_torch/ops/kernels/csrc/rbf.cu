// rbf_f32 and rbf_grad_f32: the GP model's RBF kernel matrix, and the
// three gradient sums of its hyperparameters, each entry k(x_i, x_j) made
// in registers from X and used at once by its only consumer.
//
// Replace no TPU kernel. The JAX model (cholesky_tpu/models/gp.py) leaves
// these passes to XLA, which fuses them; the port's eager torch passes made
// every n x n intermediate in device memory (D feature by feature, -0.5 D,
// / ell2, exp, amp *, W = K^-1 - alpha alpha^T, dK/dtheta and their
// products): about 37 GB of traffic in a train step at n = 8192.
//
//   rbf_f32:      K[i, j] = amp * exp(-0.5 * D[i, j] / ell2) for X1 (n, d)
//                 and X2 (m, d), with (noise + jitter) added on the
//                 diagonal when asked (X2 is X1). RAW writes D instead.
//   rbf_grad_f32: for i >= j, w = Kinv[i, j] - alpha_i alpha_j and
//                 kf = k(x_i, x_j) give the sums of w * 2 kf and
//                 w * kf * D / ell2, weighted 2 off the diagonal, and the
//                 trace of W; then g_amp = 0.5 S_amp, g_len = 0.5 S_len,
//                 g_noise = 0.5 tr * 2 * noise.
//
// The arithmetic is the plain twin's (ops/kernels/rbf.py), rounded where
// torch rounds: D = sum over f in order of (x1 - x2)^2 as __fsub_rn,
// __fmul_rn, __fadd_rn, never contracted into an FMA, so D is the twin's
// bit for bit; then -0.5 D, / ell2 (IEEE division), expf (the accurate
// one: no fast math, no __expf) and amp *. amp = exp(2 log_amp), ell2 and
// noise are computed here from the 0-d parameter tensors on the card, so
// the caller reads nothing back to the host. The gradient kernel takes
// -0.5 * (D / ell2) for -0.5 D / ell2: equal bits wherever D / ell2 is a
// normal number, and exp of anything smaller rounds to 1 either way.
//
// What bounds them on the H100: rbf_f32 the store of K, n * m * 4 bytes
// (0.080 ms at 8192^2 and 3.35 TB/s); rbf_grad_f32 the read of the lower
// triangle of K^-1 (0.040 ms at 8192). Each entry costs about 45 FP32
// instructions at d = 8 (24 for D, the IEEE division and expf about 20),
// the same order of time at the card's issue rate, so with X1 == X2 only
// the lower tiles are computed and each off-diagonal tile is stored twice,
// itself and its mirror through shared memory. A block of 256 threads
// takes a 64 x 64 tile: the tile's features are staged feature-major in
// shared memory, each thread makes 4 rows x 4 adjacent columns and stores
// each row's four as one 16-byte store, so a warp writes two 256-byte row
// segments. The gradient kernel walks the lower tiles with a fixed grid,
// loading its K^-1 entries before the distances so the loads are in flight
// while it computes, and reduces each block's sums in a fixed tree; a
// second launch sums the blocks' partials in a fixed order. No float
// atomics: the same inputs give the same bits on every run.
#include <cstdint>

#include "sgemm_tile.cuh"  // CT_EXPORT

namespace {

constexpr int TE = 64;        // tile edge
constexpr int NT = 256;       // threads: 16 groups of 4 columns x 16 rows
constexpr int RT = TE / 16;   // rows a thread: ty, ty + 16, ty + 32, ty + 48
constexpr int FC = 16;        // features staged a pass
constexpr int PITCH = TE + 1; // the mirror's shared tile

// torch.exp(2.0 * p) of a 0-d parameter on the card
__device__ __forceinline__ float exp2x(const float* p) {
  return expf(__fmul_rn(2.0f, *p));
}

// (row block, column block) of lower tile k, tiles numbered row by row
__device__ __forceinline__ void lower_tile(long long k, long long& bi,
                                           long long& bj) {
  long long b = static_cast<long long>((sqrt(8.0 * k + 1.0) - 1.0) * 0.5);
  while (b * (b + 1) / 2 > k) --b;
  while ((b + 1) * (b + 2) / 2 <= k) ++b;
  bi = b;
  bj = k - b * (b + 1) / 2;
}

// features [f0, f0 + fc) of rows [r0, r0 + TE) of the row-major X (d a
// row), feature-major: s[f][r]; rows past `rows` are 0
__device__ __forceinline__ void stage(float (*s)[TE],
                                      const float* __restrict__ X,
                                      long long rows, int d, long long r0,
                                      int f0, int fc) {
  for (int e = threadIdx.x; e < TE * fc; e += NT) {
    const int r = e / fc, f = e % fc;
    s[f][r] = r0 + r < rows ? X[(r0 + r) * d + f0 + f] : 0.0f;
  }
}

// acc[r][c] = D[i0 + ty + 16 r][j0 + 4 tx + c], summed one feature at a
// time in order, as the twin's `D += d * d`
__device__ __forceinline__ void sqdist_tile(
    float (&acc)[RT][4], float (*s1)[TE], float (*s2)[TE],
    const float* __restrict__ X1, long long n, const float* __restrict__ X2,
    long long m, int d, long long i0, long long j0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  for (int f0 = 0; f0 < d; f0 += FC) {
    const int fc = d - f0 < FC ? d - f0 : FC;
    stage(s1, X1, n, d, i0, f0, fc);
    stage(s2, X2, m, d, j0, f0, fc);
    __syncthreads();
    for (int f = 0; f < fc; ++f) {
      const float4 b4 = *reinterpret_cast<const float4*>(&s2[f][4 * tx]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float a = s1[f][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t = __fsub_rn(a, b[c]);
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(t, t));
        }
      }
    }
    __syncthreads();
  }
}

// v[0..3] into row i, columns [j, j + 4) of the row-major K, inside
// rows x cols; one 16-byte store where K's rows sit on 16 bytes
__device__ __forceinline__ void store4(float* __restrict__ K, long long ldk,
                                       long long rows, long long cols,
                                       long long i, long long j,
                                       const float (&v)[4], bool vec) {
  if (i >= rows) return;
  float* p = K + i * ldk + j;
  if (vec && j + 3 < cols) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < cols) p[c] = v[c];
  }
}

// SYM: X2 is X1 and the grid is the lower tiles, each off-diagonal one
// stored with its mirror. RAW: D itself, without the kernel's stage.
template <bool SYM, bool RAW>
__global__ void __launch_bounds__(NT, 3)
rbf_kernel(const float* __restrict__ X1, long long n,
           const float* __restrict__ X2, long long m, int d,
           const float* log_amp, const float* log_len,
           const float* log_noise, float jitter, float* __restrict__ K,
           long long ldk, bool vec) {
  __shared__ __align__(16) float s1[FC][TE];
  __shared__ __align__(16) float s2[FC][TE];
  __shared__ float mirror[SYM ? TE : 1][SYM ? PITCH : 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  long long bi, bj;
  if (SYM) {
    lower_tile(blockIdx.x, bi, bj);
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const long long i0 = bi * TE, j0 = bj * TE;
  float v[RT][4];
  sqdist_tile(v, s1, s2, X1, n, SYM ? X1 : X2, m, d, i0, j0);
  if (!RAW) {
    const float amp = exp2x(log_amp), ell2 = exp2x(log_len);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[r][c] = __fmul_rn(
            amp, expf(__fdiv_rn(__fmul_rn(-0.5f, v[r][c]), ell2)));
    if (SYM && log_noise != nullptr && bi == bj) {
      // K.diagonal().add_(noise + jitter)
      const float s = __fadd_rn(exp2x(log_noise), jitter);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (ty + 16 * r == 4 * tx + c) v[r][c] = __fadd_rn(v[r][c], s);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
    store4(K, ldk, n, m, i0 + ty + 16 * r, j0 + 4 * tx, v[r], vec);
  if (SYM && bi != bj) {
    // the mirror K[j][i]: the tile transposed through shared memory
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) mirror[4 * tx + c][ty + 16 * r] = v[r][c];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = mirror[ty + 16 * r][4 * tx + c];
      store4(K, ldk, n, n, j0 + ty + 16 * r, i0 + 4 * tx, w, vec);
    }
  }
}

// four entries of row i of K^-1 from column j, those at or below the
// diagonal; 0 elsewhere (never used)
__device__ __forceinline__ void load_lower4(float (&v)[4],
                                            const float* __restrict__ A,
                                            long long ld, long long n,
                                            long long i, long long j,
                                            bool vec) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = 0.0f;
  if (i >= n || j > i) return;
  const float* p = A + i * ld + j;
  if (vec && j + 3 < n) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c <= i) v[c] = __ldcs(p + c);
  }
}

// the sum over the block of each of q[0..2], in a fixed tree; the result
// in thread 0
__device__ __forceinline__ void block_sum3(float (&q)[3]) {
  __shared__ float warps[3][NT / 32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      q[k] = __fadd_rn(q[k], __shfl_xor_sync(0xffffffffu, q[k], o));
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) warps[k][threadIdx.x / 32] = q[k];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = warps[k][0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) s = __fadd_rn(s, warps[k][w]);
      q[k] = s;
    }
}

// each block's (S_amp, S_len, tr) over lower tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(NT, 3)
rbf_grad_partials(const float* __restrict__ Kinv, long long ld,
                  const float* __restrict__ alpha,
                  const float* __restrict__ X, long long n, int d,
                  const float* log_amp, const float* log_len,
                  long long tiles, bool vec, float* __restrict__ partials) {
  __shared__ __align__(16) float s1[FC][TE];
  __shared__ __align__(16) float s2[FC][TE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float amp = exp2x(log_amp), ell2 = exp2x(log_len);
  float q[3] = {0.0f, 0.0f, 0.0f};  // S_amp, S_len, trace of W
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    long long bi, bj;
    lower_tile(k, bi, bj);
    const long long i0 = bi * TE, j0 = bj * TE;
    float kv[RT][4], D[RT][4], ai[RT], aj[4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const long long i = i0 + ty + 16 * r;
      load_lower4(kv[r], Kinv, ld, n, i, j0 + 4 * tx, vec);
      ai[r] = i < n ? alpha[i] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long j = j0 + 4 * tx + c;
      aj[c] = j < n ? alpha[j] : 0.0f;
    }
    sqdist_tile(D, s1, s2, X, n, X, n, d, i0, j0);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long i = i0 + ty + 16 * r, j = j0 + 4 * tx + c;
        if (i >= n || j > i) continue;
        const float w = __fsub_rn(kv[r][c], __fmul_rn(ai[r], aj[c]));
        const float dl = __fdiv_rn(D[r][c], ell2);           // D / ell2
        const float kf = __fmul_rn(amp, expf(__fmul_rn(-0.5f, dl)));
        const float pa = __fmul_rn(w, __fmul_rn(2.0f, kf));  // W * dK_damp
        const float pl = __fmul_rn(w, __fmul_rn(kf, dl));    // W * dK_dlen
        if (i == j) {
          q[0] = __fadd_rn(q[0], pa);
          q[1] = __fadd_rn(q[1], pl);
          q[2] = __fadd_rn(q[2], w);
        } else {  // the entry and its mirror
          q[0] = __fadd_rn(q[0], __fmul_rn(2.0f, pa));
          q[1] = __fadd_rn(q[1], __fmul_rn(2.0f, pl));
        }
      }
  }
  block_sum3(q);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) partials[3 * blockIdx.x + k] = q[k];
}

// the blocks' partials summed in a fixed order, then the twin's formulas:
// 0.5 * S_amp, 0.5 * S_len, 0.5 * tr * 2.0 * noise
__global__ void __launch_bounds__(NT)
rbf_grad_finish(const float* __restrict__ partials, int blocks,
                const float* log_noise, float* __restrict__ out) {
  float q[3] = {0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += NT)
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = __fadd_rn(q[k], partials[3 * b + k]);
  block_sum3(q);
  if (threadIdx.x == 0) {
    out[0] = __fmul_rn(0.5f, q[0]);
    out[1] = __fmul_rn(0.5f, q[1]);
    out[2] = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, q[2]), 2.0f),
                       exp2x(log_noise));
  }
}

long long tiles_of(long long n) { return (n + TE - 1) / TE; }

bool on_16_bytes(const void* p, long long ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K (n x m, row stride ldk) from X1 (n x d) and X2 (m x d), both row-major
// and contiguous; X2 == X1 with m == n takes the lower tiles and their
// mirrors. log_noise, given only with X2 == X1, adds (noise + jitter) on
// the diagonal; raw writes D.
CT_EXPORT int ct_rbf_f32(const float* X1, long long n, const float* X2,
                         long long m, int d, const float* log_amp,
                         const float* log_len, const float* log_noise,
                         float jitter, int raw, float* K, long long ldk,
                         int device, void* stream) {
  const bool sym = X1 == X2 && n == m;
  if (n < 1 || m < 1 || d < 0 || ldk < m || (log_noise && !sym) ||
      (!raw && (!log_amp || !log_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = tiles_of(n), mt = tiles_of(m);
  if ((sym && nt * (nt + 1) / 2 > 0x7fffffffLL) || (!sym && nt > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = on_16_bytes(K, ldk);
  const dim3 grid = sym ? dim3(static_cast<unsigned>(nt * (nt + 1) / 2))
                        : dim3(static_cast<unsigned>(mt),
                               static_cast<unsigned>(nt));
  if (sym && raw)
    rbf_kernel<true, true><<<grid, NT, 0, s>>>(X1, n, X2, m, d, log_amp,
                                               log_len, log_noise, jitter, K,
                                               ldk, vec);
  else if (sym)
    rbf_kernel<true, false><<<grid, NT, 0, s>>>(X1, n, X2, m, d, log_amp,
                                                log_len, log_noise, jitter, K,
                                                ldk, vec);
  else if (raw)
    rbf_kernel<false, true><<<grid, NT, 0, s>>>(X1, n, X2, m, d, log_amp,
                                                log_len, log_noise, jitter, K,
                                                ldk, vec);
  else
    rbf_kernel<false, false><<<grid, NT, 0, s>>>(X1, n, X2, m, d, log_amp,
                                                 log_len, log_noise, jitter,
                                                 K, ldk, vec);
  return static_cast<int>(cudaGetLastError());
}

// g_amp, g_len, g_noise into out[0..2] from the lower triangle of Kinv
// (n x n, row stride ld), alpha (n) and X (n x d, row-major, contiguous);
// partials holds 3 * blocks floats
CT_EXPORT int ct_rbf_grad_f32(const float* Kinv, long long ld,
                              const float* alpha, const float* X,
                              long long n, int d, const float* log_amp,
                              const float* log_len, const float* log_noise,
                              int blocks, float* partials, float* out,
                              int device, void* stream) {
  if (n < 1 || d < 0 || ld < n || blocks < 1 || !log_amp || !log_len ||
      !log_noise)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long nt = tiles_of(n);
  rbf_grad_partials<<<blocks, NT, 0, s>>>(Kinv, ld, alpha, X, n, d, log_amp,
                                          log_len, nt * (nt + 1) / 2,
                                          on_16_bytes(Kinv, ld), partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rbf_grad_finish<<<1, NT, 0, s>>>(partials, blocks, log_noise, out);
  return static_cast<int>(cudaGetLastError());
}
