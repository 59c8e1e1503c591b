// mm_groups_f32pair: every int8 slice product of an Ozaki f64 product,
// summed by weight group, as an f32 (hi, lo) pair.
//
// Replaces cholesky_tpu/ops/pallas/ozaki_mm.py:mm_groups_f32pair
// (_make_kernel, _two_sum_into). With As (S, m, k) the int8 row slices of A
// and Bs (S, n, k) those of Bᵀ (ops/ozaki.py split_rows), it returns hi, lo
// (m, n) f32 with
//     hi + lo = sum_g 2^(-7(g+2)) G_g,   G_g = sum_{s+t=g} As[s]·Bs[t]ᵀ,
// g < S (the pairs with s + t >= S are dropped, as in the JAX package); the
// caller applies the f64 row and column scales.
//
// What bounds it on the H100: int8 operations, 2·m·n·k·S(S+1)/2 of them
// (21 products at S = 6; 1.47 ms for 4096³ at the 1979 TOP/s dense int8
// peak), against S(m + n)k + 8mn bytes. The TPU kernel ran the slice
// products on the MXU and converted each k-step's group sums to f32 there.
// Here the products run on the int8 tensor cores through
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, which takes both operands
// k-major, the layout the peel writes. The conversion is the costly part
// on this card: a 12/12-bit split and two Knuth two-sums per group and
// element are about 20 FP32 instructions, against the 4 clocks of one
// m16n8k32 product, so converting after every 32-wide k-step would leave
// the kernel bound by the FP32 instruction rate, near a sixth of the
// tensor-core rate.
// Instead each group's int32 sum runs over a k-chunk of up to KCHUNK, exact
// (|G| <= 8·65²·KCHUNK < 2^31), and is converted once per chunk: its two
// 12/12-bit halves are below 2^19 and 2^12, so both are exact in f32, and
// the power-of-two weight keeps them exact; the pair then absorbs them by
// two-sum. For every product with k <= KCHUNK, which is all of those of the
// d drivers below n = 32768, that is one conversion per group, and the pair
// is more exact than the TPU's.
//
// Design: one 128-thread block per 64 x 64 output tile, four warps of
// 32 x 32 (2 x 4 mma tiles). The groups run one after another, each over
// the whole k-chunk with its own int32 accumulators (32 registers), so a
// thread never holds more than one group: per 32-wide k-step the block
// stages slices 0..g of its A rows and B rows in shared memory (16-byte
// loads, rows padded to 48 bytes so the 4-byte fragment loads of a warp
// hit 32 distinct banks) and runs the g + 1 products of the group. That
// stages S(S+1) slice tiles per k-step instead of 2S, from L2 mostly; a
// ring of stages (cp.async or TMA) and wgmma are later work.
//
// Operands are strided views (slice stride, row stride, unit k stride), so
// the hoisted recursions of ops/blocked.py pass sub-blocks of one shared
// peel, such as Ls[:, i + n1:i + n, i:i + n1], without a copy. Every row
// must start on a 16-byte boundary: the pointer (with its k offset) and
// both strides are multiples of 16, which the wrapper checks and refuses
// otherwise. A ragged k end is loaded byte by byte and zero-filled.
#include "sgemm_tile.cuh"  // CT_EXPORT

namespace {

constexpr int BM = 64, BN = 64;   // output tile
constexpr int BK = 32;            // k-step: the depth of one mma
constexpr int PITCH = BK + 16;    // bytes per staged row
constexpr int NT = 128;           // four warps, 2 x 2 over the tile
constexpr int MAX_SLICES = 8;
constexpr int KCHUNK = 32768;     // 8 · 65² · 32768 < 2^31
static_assert(MAX_SLICES * (BM + BN) * PITCH <= 48 * 1024,
              "the staged slices must fit the default shared memory");

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of X[s, row, kc:kc + 16] into dst, zero past `rows` and past K.
__device__ __forceinline__ void stage_chunk(const signed char* __restrict__ X,
                                            long long ss, long long sr, int s,
                                            int row, int rows, int kc, int K,
                                            signed char* dst) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row < rows && kc < K) {
    const signed char* p = X + s * ss + row * sr + kc;
    if (kc + 16 <= K) {
      v = *reinterpret_cast<const int4*>(p);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < K - kc; ++e)
        w[e / 4] |= static_cast<unsigned>(static_cast<unsigned char>(p[e]))
                    << (8 * (e % 4));
      v = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                    static_cast<int>(w[2]), static_cast<int>(w[3]));
    }
  }
  *reinterpret_cast<int4*>(dst) = v;
}

// hi + lo += t exactly in hi (Knuth two-sum), the error rounded into lo.
__device__ __forceinline__ void two_sum_into(float& hi, float& lo, float t) {
  const float s = __fadd_rn(hi, t);
  const float z = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, z)), __fsub_rn(t, z));
  hi = s;
  lo = __fadd_rn(lo, e);
}

__global__ void __launch_bounds__(NT)
mm_groups_kernel(const signed char* __restrict__ A, long long sa_s,
                 long long sa_r, const signed char* __restrict__ B,
                 long long sb_s, long long sb_r, float* __restrict__ hi_out,
                 float* __restrict__ lo_out, long long ldc, int S, int m,
                 int n, int K) {
  extern __shared__ __align__(16) signed char smem[];
  signed char* As = smem;                     // [S][BM][PITCH]
  signed char* Bs = smem + S * BM * PITCH;    // [S][BN][PITCH]
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane >> 2, tq = lane & 3;    // mma group and thread in it
  // this thread's staging chunk: row tid / 2, bytes (tid % 2) * 16
  const int sr = threadIdx.x / 2, sc = (threadIdx.x % 2) * 16;

  float hi[2][4][4], lo[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[mi][ni][e] = lo[mi][ni][e] = 0.f;

  for (int kc0 = 0; kc0 < K; kc0 += KCHUNK) {
    const int kend = min(K, kc0 + KCHUNK);
    for (int g = 0; g < S; ++g) {
      int acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

      for (int k0 = kc0; k0 < kend; k0 += BK) {
        for (int s = 0; s <= g; ++s) {
          stage_chunk(A, sa_s, sa_r, s, r0 + sr, m, k0 + sc, kend,
                      As + (s * BM + sr) * PITCH + sc);
          stage_chunk(B, sb_s, sb_r, s, c0 + sr, n, k0 + sc, kend,
                      Bs + (s * BN + sr) * PITCH + sc);
        }
        __syncthreads();
        for (int s = 0; s <= g; ++s) {
          const signed char* as = As + s * BM * PITCH;
          const signed char* bs = Bs + (g - s) * BN * PITCH;
          unsigned a[2][4], b[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const signed char* p = as + (wm + mi * 16 + gq) * PITCH + tq * 4;
            a[mi][0] = *reinterpret_cast<const unsigned*>(p);
            a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH);
            a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
            a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH + 16);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const signed char* p = bs + (wn + ni * 8 + gq) * PITCH + tq * 4;
            b[ni][0] = *reinterpret_cast<const unsigned*>(p);
            b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
      }

      // G = 4096·ghi + glo, glo in [0, 4095]: both halves exact in f32, and
      // so are their products with the power-of-two weight 2^(-7(g+2))
      const float w = __int_as_float((127 - 7 * (g + 2)) << 23);
      const float w_hi = __fmul_rn(4096.f, w);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int G = acc[mi][ni][e];
            const int ghi = G >> 12;                  // floor(G / 4096)
            const int glo = G - ghi * 4096;
            two_sum_into(hi[mi][ni][e], lo[mi][ni][e],
                         __fmul_rn(__int2float_rn(ghi), w_hi));
            two_sum_into(hi[mi][ni][e], lo[mi][ni][e],
                         __fmul_rn(__int2float_rn(glo), w));
          }
    }
  }

  // renormalize (|lo| <= ulp(hi) / 2) and store; c[e] of an m16n8 tile is
  // row gq (+8 for e >= 2), column 2 tq + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wm + mi * 16 + gq + (e >= 2 ? 8 : 0);
        const int c = c0 + wn + ni * 8 + tq * 2 + (e & 1);
        if (r < m && c < n) {
          const float h = hi[mi][ni][e], l = lo[mi][ni][e];
          const float s = __fadd_rn(h, l);
          hi_out[r * ldc + c] = s;
          lo_out[r * ldc + c] = __fsub_rn(l, __fsub_rn(s, h));
        }
      }
}

bool aligned16(const void* p, long long ss, long long sr) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && ss % 16 == 0 &&
         sr % 16 == 0;
}

}  // namespace

CT_EXPORT int ct_mm_groups_f32pair(const signed char* A, long long sa_s,
                                   long long sa_r, const signed char* B,
                                   long long sb_s, long long sb_r, float* hi,
                                   float* lo, long long ldc, int S, int m,
                                   int n, int k, int device, void* stream) {
  if (S < 1 || S > MAX_SLICES || m < 1 || n < 1 || k < 0 || ldc < n ||
      !aligned16(A, sa_s, sa_r) || !aligned16(B, sb_s, sb_r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const size_t smem = static_cast<size_t>(S) * (BM + BN) * PITCH;
  mm_groups_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      A, sa_s, sa_r, B, sb_s, sb_r, hi, lo, ldc, S, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
