// peel_f32pair: the S int8 slices of 7 bits of an exact f32 pair (rh, rl).
//
// Replaces cholesky_tpu/ops/pallas/ozaki_split.py:peel_f32pair
// (_make_peel_kernel), the peel of the d tier's Ozaki products
// (ops/ozaki.py split_rows): every f64 operand, already scaled row by row
// into [-1/2, 1/2] by a power of two and held as the exact pair rh + rl,
// becomes S slices q_s with rh + rl = sum_s q_s 2^(-7(s+1)) + a remainder
// below 2^(-7S). Each round is q = round(128 rh) (half to even, as
// jnp.round), then rh, rl := the two-sum of 128 rh - q and 128 rl.
//
// The slices must be bit for bit those of the JAX package, so every
// operation is written with an intrinsic that rounds to nearest
// (__fmul_rn, __fsub_rn, __fadd_rn): nvcc may not contract any of them into
// an FMA, and the build never passes --use_fast_math. rintf rounds half to
// even; roundf would round half away from zero.
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
// The output rows are padded to kp, a multiple of 16 bytes, with zeros:
// mm_groups_f32pair (ozaki_mm.cu) loads 16-byte chunks and needs every row
// of a slice, and of any sub-block at a k offset that is a multiple of 16,
// to start on a 16-byte boundary.
#include "sgemm_tile.cuh"  // CT_EXPORT

namespace {

constexpr int NT = 256;
constexpr int VEC = 4;     // elements per thread
constexpr int MAX_SLICES = 8;

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
    for (int v = 0; v < VEC; ++v) {
      const float hb = __fmul_rn(h[v], 128.f);     // exact: a power of two
      const float qf = rintf(hb);                  // |q| <= 65
      q[v] = static_cast<signed char>(__float2int_rz(qf));
      const float d = __fsub_rn(hb, qf);           // |d| <= 1/2: exact
      const float lb = __fmul_rn(l[v], 128.f);
      const float t = __fadd_rn(d, lb);            // two-sum: new hi ...
      l[v] = __fsub_rn(lb, __fsub_rn(t, d));       // ... and its error
      h[v] = t;
    }
    *reinterpret_cast<char4*>(o + s * sso) = make_char4(q[0], q[1], q[2], q[3]);
  }
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
