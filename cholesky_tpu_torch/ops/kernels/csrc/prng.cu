// uniform_fill_f32 and uniform_fill_f64: uniform fills of a row-major
// rows x cols buffer in [0, 1), from a counter-based generator.
//
// Replace cholesky_tpu/rng/pallas_prng.py:uniform_device (_fill_kernel) and
// uniform_device64 (_fill_kernel64). The TPU kernels seed the core's
// hardware PRNG once per block of 256 rows with a hashed seed
// (_mix_seeds) and draw the block's bits. The card has no such generator
// whose bits anyone could reproduce, so each element's bits come from
// Philox4x32-10 (Salmon et al., SC'11; the generator of cuRAND's Philox):
// the key is (the row block's hashed seed, 0), the counter the element's
// position in its row block, divided by the number of elements one call
// serves. The result depends only on (seeds, rows, cols), and the plain
// twin in ops/kernels/prng.py computes the same words with torch integer
// arithmetic, bit for bit.
//
//   f32: one call gives four elements; each 32-bit word w becomes the
//        float with exponent 0 and mantissa w >> 9, in [1, 2), minus 1
//        (exact), as the TPU kernel does.
//   f64: one call gives two elements, each from a word pair (hi, lo) as
//        ((hi << 21) | (lo >> 11)) * 2^-53, the JAX package's 53-bit
//        construction: u < 1 strictly, on the 2^-53 grid.
//
// What bounds it on the H100: the stores, rows * cols * 4 (or 8) bytes:
// 0.080 ms (0.160 ms in f64) at 8192 x 8192 and 3.35 TB/s. Ten Philox
// rounds are about 60 integer operations per call, 15 (30) per element,
// far below the card's integer rate at that byte rate. Each thread makes
// one call and writes its elements as one 16-byte store; a row block is
// contiguous in the output, so the stores of a warp are too.
#include <cstdint>

#include "sgemm_tile.cuh"  // CT_EXPORT

namespace {

constexpr int NT = 256;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// Philox4x32-10: ten rounds, the key bumped by the Weyl constants between
// rounds (Random123's philox4x32_R with R = 10).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float unit_f32(uint32_t w) {
  return __uint_as_float(0x3F800000u | (w >> 9)) - 1.0f;
}

__device__ __forceinline__ double unit_f64(uint32_t hi, uint32_t lo) {
  const unsigned long long m =
      (static_cast<unsigned long long>(hi) << 21) | (lo >> 11);
  return __ull2double_rn(m) * 0x1p-53;
}

// blockIdx.y is the row block; thread t of it makes call t, which serves
// the elements [E*t, E*t + E) of the block (E = 4 in f32, 2 in f64).
template <typename T, int E>
__global__ void __launch_bounds__(NT)
fill_kernel(const int* __restrict__ seeds, long long rows, long long cols,
            int rp, T* __restrict__ out) {
  const long long b = blockIdx.y;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long p0 = E * t;
  const long long block_rows = rows - b * rp < rp ? rows - b * rp : rp;
  const long long live = block_rows * cols;
  if (p0 >= live) return;
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(t), static_cast<uint32_t>(t >> 32), 0u,
                 0u),
      static_cast<uint32_t>(seeds[b]), 0u);
  T v[E];
  if constexpr (E == 4) {
    v[0] = unit_f32(w.x);
    v[1] = unit_f32(w.y);
    v[2] = unit_f32(w.z);
    v[3] = unit_f32(w.w);
  } else {
    v[0] = unit_f64(w.x, w.y);
    v[1] = unit_f64(w.z, w.w);
  }
  // rp is a multiple of 8, so every row block and every call's first
  // element start on 16 bytes
  T* o = out + b * rp * cols + p0;
  if (p0 + E <= live) {
    if constexpr (E == 4)
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<double2*>(o) = make_double2(v[0], v[1]);
  } else {
    // the ragged end of a row block; unrolled, so v stays in registers
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (p0 + j < live) o[j] = v[j];
  }
}

template <typename T, int E>
int launch(const int* seeds, long long rows, long long cols, int rp, T* out,
           int device, void* stream) {
  if (rows < 1 || cols < 1 || rp < 8 || rp % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = (rows + rp - 1) / rp;
  const long long calls = (static_cast<long long>(rp) * cols + E - 1) / E;
  const long long grid_x = (calls + NT - 1) / NT;
  if (nblocks > 65535 || grid_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(nblocks));
  fill_kernel<T, E><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, rows, cols, rp, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

CT_EXPORT int ct_uniform_fill_f32(const int* seeds, long long rows,
                                  long long cols, int rp, float* out,
                                  int device, void* stream) {
  return launch<float, 4>(seeds, rows, cols, rp, out, device, stream);
}

CT_EXPORT int ct_uniform_fill_f64(const int* seeds, long long rows,
                                  long long cols, int rp, double* out,
                                  int device, void* stream) {
  return launch<double, 2>(seeds, rows, cols, rp, out, device, stream);
}
