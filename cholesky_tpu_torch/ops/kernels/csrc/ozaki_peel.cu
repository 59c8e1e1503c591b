// The Ozaki peel of the d tier's products (ops/ozaki.py split_rows):
// peel_f32pair, the S int8 slices of 7 bits of an exact f32 pair (rh, rl),
// and peel_f64, the same slices and the row scales straight from an f64
// matrix, the scaling pass included.
//
// peel_f32pair replaces cholesky_tpu/ops/pallas/ozaki_split.py:peel_f32pair
// (_make_peel_kernel): every f64 operand, already scaled row by row
// into [-1/2, 1/2] by a power of two and held as the exact pair rh + rl,
// becomes S slices q_s with rh + rl = sum_s q_s 2^(-7(s+1)) + a remainder
// below 2^(-7S). Each round is q = round(128 rh) (half to even, as
// jnp.round), then rh, rl := the two-sum of 128 rh - q and 128 rl.
//
// The slices must be bit for bit those of the JAX package, so every
// operation is written with an intrinsic that rounds to nearest
// (__fmul_rn, __fsub_rn, __fadd_rn, __dsub_rn, __dmul_rn): nvcc may not
// contract any of them into an FMA, and the build never passes
// --use_fast_math. rintf rounds half to even; roundf would round half away
// from zero.
//
// What bounds it on the H100: bytes. It reads 8 bytes and writes S per
// element (14 at S = 6: 0.28 ms for an 8192 x 8192 operand at 3.35 TB/s);
// its 10 S flops per element are nothing beside that. The TPU kernel ran
// all S rounds on a VMEM block so the pair never went back to HBM; here
// each thread keeps the pair of four neighbouring elements in registers for
// all S rounds, reads them once (as a float4 where the layout allows) and
// writes each slice as one 4-byte store, so the pass over device memory is
// the minimal one.
//
// peel_f64 replaces no TPU kernel: the JAX package leaves the scaling to
// XLA, which fuses it; eagerly it was some thirty torch passes a peel
// (ops/ozaki.py scaled_pair), which set the d tier's pace on the host. It
// computes, row by row in registers, exactly what scaled_pair and
// peel_f32pair compute: the f64 row max of |A| (NaN wins, a zero max
// becomes 1), rounded to f32 and split by frexpf; the powers of two
// 1 / (2 scale) and scale from the bits of the f64 power, as _pow2_f32;
// xh = f32(a), xl = f32(a - xh), both times 1 / (2 scale); then the S
// rounds. It reads the f64 view twice (the max, then the peel: 16 + S
// bytes an element, 0.4 ms at 8192², S = 6) and is chosen by the view's
// strides:
// - rows along the unit stride (a row-major block): one warp a row, its
//   max by shuffles; each slice store is 32 neighbouring bytes of a warp;
// - rows across it (a transposed view, s0 = 1): 32 rows a block, read
//   along the rows, the max over k per row from 8 partial maxima in
//   shared memory; the slices of a 32 x 32 tile go through shared memory
//   so that each row's 32 bytes are stored together.
// A block walks its rows' whole k, so a view of few rows (the hoisted
// trsm recursions peel B[:n1].T, nrhs rows) made a grid of one or a few
// blocks whose threads each read hundreds of elements in turn. Where the
// rows cannot fill the card, each kernel splits k into chunks of at least
// KMIN columns, a block a (rows, chunk) pair, as one cooperative launch:
// every block merges its rows' partial maxima into the row's scale with
// atomicMax on the bits, and after a grid sync each peels its chunk with
// the row's max. The result is the same bit for bit.
//
// The output rows are padded to kp, a multiple of 16 bytes, with zeros:
// mm_groups_f32pair (ozaki_mm.cu) loads 16-byte chunks and needs every row
// of a slice, and of any sub-block at a k offset that is a multiple of 16,
// to start on a 16-byte boundary.
#include <cooperative_groups.h>

#include "sgemm_tile.cuh"  // CT_EXPORT

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int VEC = 4;     // elements per thread
constexpr int MAX_SLICES = 8;

// One round: q = round(128 h), half to even; h, l := the two-sum of
// 128 h - q and 128 l.
__device__ __forceinline__ signed char peel_round(float& h, float& l) {
  const float hb = __fmul_rn(h, 128.f);     // exact: a power of two
  const float qf = rintf(hb);               // |q| <= 65
  const float d = __fsub_rn(hb, qf);        // |d| <= 1/2: exact
  const float lb = __fmul_rn(l, 128.f);
  const float t = __fadd_rn(d, lb);         // two-sum: new hi ...
  l = __fsub_rn(lb, __fsub_rn(t, d));       // ... and its error
  h = t;
  return static_cast<signed char>(__float2int_rz(qf));
}

// 2^e in f32 from the bits of the f64 power of two, as ops/ozaki.py's
// _pow2_f32: exact for a normal or subnormal result, 0 below 2^-149, inf
// above 2^127
__device__ __forceinline__ float pow2_f32(int e) {
  const unsigned long long bits =
      static_cast<unsigned long long>(static_cast<long long>(e) + 1023) << 52;
  return __double2float_rn(__longlong_as_double(static_cast<long long>(bits)));
}

// max(m, b) where a NaN wins, as torch's amax
__device__ __forceinline__ double nan_max(double m, double b) {
  return (b > m || b != b) ? b : m;
}

// The scale of a row from its max |a|: inv = 1 / (2 scale) in f32 and the
// returned row scale 2 scale in f64, scale = 2^ex from the f32 frexp of
// the max (a zero max counts as 1)
struct RowScale {
  float inv;
  double scale;
};

__device__ __forceinline__ RowScale row_scale(double amax) {
  if (amax == 0.0) amax = 1.0;
  int ex;
  frexpf(__double2float_rn(amax), &ex);
  return {pow2_f32(-(ex + 1)),
          __dmul_rn(2.0, static_cast<double>(pow2_f32(ex)))};
}

// The scaled exact pair of one element: f32(a) and f32(a - f32(a)), each
// times inv
__device__ __forceinline__ void scaled(double a, float inv, float& h,
                                       float& l) {
  const float xh = __double2float_rn(a);
  const float xl = __double2float_rn(__dsub_rn(a, static_cast<double>(xh)));
  h = __fmul_rn(xh, inv);
  l = __fmul_rn(xl, inv);
}

__global__ void __launch_bounds__(NT)
peel_f32pair_kernel(const float* __restrict__ rh, long long sh0, long long sh1,
                    const float* __restrict__ rl, long long sl0, long long sl1,
                    signed char* __restrict__ out, long long ldo,
                    long long sso, int m, int k, int kp, int slices,
                    int vec_in) {
  const long long per_row = kp / VEC;
  const long long idx =
      static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (idx >= m * per_row) return;
  const long long i = idx / per_row;
  const int j0 = static_cast<int>(idx % per_row) * VEC;
  float h[VEC], l[VEC];
  if (vec_in && j0 + VEC <= k) {
    const float4 a = *reinterpret_cast<const float4*>(rh + i * sh0 + j0);
    const float4 b = *reinterpret_cast<const float4*>(rl + i * sl0 + j0);
    h[0] = a.x, h[1] = a.y, h[2] = a.z, h[3] = a.w;
    l[0] = b.x, l[1] = b.y, l[2] = b.z, l[3] = b.w;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int j = j0 + v;
      h[v] = j < k ? rh[i * sh0 + j * sh1] : 0.f;  // the padding peels to 0
      l[v] = j < k ? rl[i * sl0 + j * sl1] : 0.f;
    }
  }
  signed char* o = out + i * ldo + j0;
  for (int s = 0; s < slices; ++s) {
    signed char q[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) q[v] = peel_round(h[v], l[v]);
    *reinterpret_cast<char4*>(o + s * sso) = make_char4(q[0], q[1], q[2], q[3]);
  }
}

constexpr int WARPS = NT / 32;
constexpr int TI = 32;       // rows of a transposed view's tile
constexpr int TJ = 32;       // columns of its slice tile
constexpr int QS = TJ + 4;   // bytes a row of the slice tile takes

// The row max of a peel whose k is split among blocks (SPLIT), each
// holding the maximum of its chunk in mx where ``mine``; every thread of the
// grid calls it. acc, the row's scale, serves as the accumulator: chunk 0
// zeroes it, each block merges its maximum into it with atomicMax on the
// bits (|a| >= 0 orders as its bits, and a NaN's lie above +inf's, so that
// is nan_max), and each reads the row's max back. The last sync keeps
// chunk 0 from writing the scale over it before every block has read it.
template <bool SPLIT>
__device__ __forceinline__ double row_max(double mx, double* acc, bool mine) {
  if constexpr (SPLIT) {
    cg::grid_group grid = cg::this_grid();
    auto* bits = reinterpret_cast<unsigned long long*>(acc);
    if (mine && blockIdx.y == 0) *bits = 0ull;
    grid.sync();
    if (mine)
      atomicMax(bits,
                static_cast<unsigned long long>(__double_as_longlong(mx)));
    grid.sync();
    if (mine) mx = __longlong_as_double(static_cast<long long>(__ldcg(bits)));
    grid.sync();
  }
  return mx;
}

// peel_f64 on a view whose rows run along the unit stride: one warp a row,
// over all of k, or over the kc columns of chunk blockIdx.y (SPLIT)
template <bool SPLIT>
__global__ void __launch_bounds__(NT)
peel_f64_rows_kernel(const double* __restrict__ A, long long s0, long long s1,
                     signed char* __restrict__ out, long long ldo,
                     long long sso, double* __restrict__ scale, int m, int k,
                     int kp, int slices, int kc) {
  const int lane = threadIdx.x % 32;
  const long long i =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const bool live = i < m;
  if (!SPLIT && !live) return;         // the whole warp: one row a warp
  const int c0 = SPLIT ? blockIdx.y * kc : 0;
  const int c1 = SPLIT ? min(c0 + kc, kp) : kp;
  const double* a = A + i * s0;
  double mx = 0.0;
  if (live) {
#pragma unroll 4
    for (int j = c0 + lane; j < min(c1, k); j += 32)
      mx = nan_max(mx, fabs(a[j * s1]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (SPLIT)
    mx = __shfl_sync(0xffffffffu,
                     row_max<SPLIT>(mx, scale + i, live && lane == 0), 0);
  if (!live) return;                   // after the split's grid syncs
  const RowScale rs = row_scale(mx);
  if (lane == 0 && blockIdx.y == 0) scale[i] = rs.scale;
  signed char* o = out + i * ldo;
  for (int j = c0 + lane; j < c1; j += 32) {
    float h = 0.f, l = 0.f;            // the padding peels to 0
    if (j < k) scaled(a[j * s1], rs.inv, h, l);
    for (int s = 0; s < slices; ++s) o[s * sso + j] = peel_round(h, l);
  }
}

// peel_f64 on a view whose rows run across the unit stride (s0 = 1): TI
// rows a block, thread (tx, ty) on row tx and every WARPS-th column, over
// all of k, or over the kc columns of chunk blockIdx.y (SPLIT; kc is a
// multiple of TJ)
template <bool SPLIT>
__global__ void __launch_bounds__(NT)
peel_f64_cols_kernel(const double* __restrict__ A, long long s0, long long s1,
                     signed char* __restrict__ out, long long ldo,
                     long long sso, double* __restrict__ scale, int m, int k,
                     int kp, int slices, int kc) {
  __shared__ double part[WARPS][TI];
  __shared__ float inv_of[TI];
  __shared__ __align__(16) signed char q[MAX_SLICES][TI][QS];
  const int tx = threadIdx.x % TI, ty = threadIdx.x / TI;
  const long long i0 = static_cast<long long>(blockIdx.x) * TI;
  const bool live = i0 + tx < m;
  const int c0 = SPLIT ? blockIdx.y * kc : 0;
  const int c1 = SPLIT ? min(c0 + kc, kp) : kp;
  const double* a = A + (i0 + tx) * s0;
  double mx = 0.0;
  if (live) {
#pragma unroll 4
    for (int j = c0 + ty; j < min(c1, k); j += WARPS)
      mx = nan_max(mx, fabs(a[j * s1]));
  }
  part[ty][tx] = mx;
  __syncthreads();
  if (ty == 0)
    for (int w = 1; w < WARPS; ++w) mx = nan_max(mx, part[w][tx]);
  mx = row_max<SPLIT>(mx, scale + i0 + tx, ty == 0 && live);
  if (ty == 0) {
    const RowScale rs = row_scale(mx);
    inv_of[tx] = rs.inv;
    if (live && blockIdx.y == 0) scale[i0 + tx] = rs.scale;
  }
  __syncthreads();
  const float inv = inv_of[tx];
  // thread t stores bytes c4 .. c4 + 3 of row r of each slice tile
  const int r = threadIdx.x / (TJ / 4), c4 = threadIdx.x % (TJ / 4) * 4;
  for (int j0 = c0; j0 < c1; j0 += TJ) {
    for (int c = ty; c < TJ; c += WARPS) {
      float h = 0.f, l = 0.f;          // the padding peels to 0
      if (live && j0 + c < k) scaled(a[(j0 + c) * s1], inv, h, l);
      for (int s = 0; s < slices; ++s) q[s][tx][c] = peel_round(h, l);
    }
    __syncthreads();
    if (i0 + r < m && j0 + c4 < c1) {  // c1 is a multiple of 4
      signed char* o = out + (i0 + r) * ldo + j0 + c4;
      for (int s = 0; s < slices; ++s)
        *reinterpret_cast<int*>(o + s * sso) =
            *reinterpret_cast<const int*>(&q[s][r][c4]);
    }
    __syncthreads();
  }
}

constexpr int KMIN = 256;      // the fewest columns of a split peel's chunk
constexpr int MAX_DEVICES = 64;

// The co-resident blocks of each split kernel (rows, cols) on a device,
// found once: 0 until then, -1 where the device has no cooperative launch;
// and the device's SM count.
int split_cap[MAX_DEVICES][2];
int sm_count[MAX_DEVICES];

cudaError_t init_device(int device) {
  int coop = 0, nsm = 0, rows = 0, cols = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &rows, peel_f64_rows_kernel<true>, NT, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &cols, peel_f64_cols_kernel<true>, NT, 0);
  if (err != cudaSuccess) return err;
  split_cap[device][0] = coop && rows > 0 ? nsm * rows : -1;
  split_cap[device][1] = coop && cols > 0 ? nsm * cols : -1;
  sm_count[device] = nsm;
  return cudaSuccess;
}

}  // namespace

CT_EXPORT int ct_peel_f32pair(const float* rh, long long sh0, long long sh1,
                              const float* rl, long long sl0, long long sl1,
                              signed char* out, long long ldo, long long sso,
                              int m, int k, int kp, int slices, int vec_in,
                              int device, void* stream) {
  if (m < 1 || k < 1 || kp < k || kp % 16 != 0 || ldo < kp ||
      ldo % 16 != 0 || sso % 16 != 0 || slices < 1 || slices > MAX_SLICES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(m) * (kp / VEC);
  const unsigned blocks = static_cast<unsigned>((threads + NT - 1) / NT);
  peel_f32pair_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      rh, sh0, sh1, rl, sl0, sl1, out, ldo, sso, m, k, kp, slices, vec_in);
  return static_cast<int>(cudaGetLastError());
}

CT_EXPORT int ct_peel_f64(const double* A, long long s0, long long s1,
                          signed char* out, long long ldo, long long sso,
                          double* scale, int m, int k, int kp, int slices,
                          int device, void* stream) {
  if (m < 1 || k < 0 || kp < k || kp < 16 || kp % 16 != 0 || ldo < kp ||
      ldo % 16 != 0 || sso % 16 != 0 || slices < 1 || slices > MAX_SLICES ||
      device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sm_count[device]) {
    err = init_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cols = s0 == 1 && s1 != 1;   // rows across the unit stride
  const int per_block = cols ? TI : WARPS;
  const int tiles = (m + per_block - 1) / per_block;
  // a grid of fewer blocks than SMs splits k: about two blocks an SM,
  // within the co-resident limit, chunks of KMIN columns or more
  const int cap = split_cap[device][cols];
  int chunks = 1, kc = kp;
  if (cap > 0 && tiles < sm_count[device]) {
    chunks = min((kp + KMIN - 1) / KMIN,
                 min((2 * sm_count[device] + tiles - 1) / tiles, cap / tiles));
    if (chunks > 1) {
      kc = ((kp + chunks - 1) / chunks + TJ - 1) / TJ * TJ;
      chunks = (kp + kc - 1) / kc;
    }
  }
  if (chunks > 1) {
    void* args[] = {&A, &s0, &s1, &out, &ldo, &sso, &scale, &m, &k, &kp,
                    &slices, &kc};
    const void* fn = cols ? reinterpret_cast<const void*>(
                                peel_f64_cols_kernel<true>)
                          : reinterpret_cast<const void*>(
                                peel_f64_rows_kernel<true>);
    err = cudaLaunchCooperativeKernel(fn, dim3(tiles, chunks), dim3(NT), args,
                                      0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (cols) {
    peel_f64_cols_kernel<false><<<tiles, NT, 0, st>>>(
        A, s0, s1, out, ldo, sso, scale, m, k, kp, slices, kp);
  } else {
    peel_f64_rows_kernel<false><<<tiles, NT, 0, st>>>(
        A, s0, s1, out, ldo, sso, scale, m, k, kp, slices, kp);
  }
  return static_cast<int>(cudaGetLastError());
}
