// mm_groups_f32pair: every int8 slice product of an Ozaki f64 product,
// summed by weight group, as an f32 (hi, lo) pair; mm_groups_f64: the same
// products with the f64 epilogue, merged into the caller's f64 matrix.
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
// (21 products at S = 6; 1.46 ms for 4096³ at the 1979 TOP/s dense int8
// peak), against S(m + n)k + 8mn bytes. Running the groups one after
// another, each over all of k, stages slices 0..g of both operands again
// for every group: S(S+1) slice tiles per k-step where 2S carry the data.
//
// Design: one block per 64 x BN output tile, ceil(S/2) warpgroups. BN is
// 128 where 64 x 64 tiles would fill the 132 SMs twice over and S <= 6
// (4096³ on an H100: 4.2 ms against 6.1 at BN = 64), else 64, which keeps
// more blocks on a small product (the d tier's 128³ leaf products: 27 us on
// two 64 x 128 blocks, 15 on four 64 x 64 ones). Each k-step of 32 stages
// the S slices of the block's A rows and B rows ONCE (S·(64 + BN)·32
// bytes) into a ring of shared-memory stages (5 at BN = 64, 4 at 128)
// by cp.async (16-byte copies, zero-filled past the last row and past k),
// issued STAGES - 2 steps ahead by every thread, while one batch of
// products stays in flight across the step's barrier. Warpgroup q owns
// groups q and S-1-q (one group for the middle warpgroup at odd S):
// (q + 1) + (S - q) = S + 1 products per k-step for every warpgroup,
// balanced, each an asynchronous wgmma.m64nBNk32.s32.s8.s8 reading both
// operands from shared memory (k-major, 32-byte swizzle), issued
// straight-line (the kernel is a template on S and BN). Every group's
// int32 sum stays live in registers (BN / 2 per thread per group) over one
// pass of k. The sums are exact over a k-chunk of up to KCHUNK
// (|G| <= 8·65²·KCHUNK < 2^31) and are converted once per chunk: each
// G = 4096·ghi + glo, both halves exact in f32 (below 2^19 and 2^12), and
// so are their products with the power-of-two weight; the warpgroups then
// absorb them by Knuth two-sums into one (hi, lo) pair kept in shared
// memory, in turn (warpgroup 0's groups 0 and S-1 first), and the last one
// stores the pair. For every product with k <= KCHUNK, which is all of
// those of the d drivers below n = 32768, that is one conversion per
// group. The two-sums run in that order, not group 0, 1, ..., S-1 as in
// the JAX kernel, so the low bits of lo may differ from a group-ordered
// sum; the pair stays within about 2^-46 of the exact sum either way.
//
// Operands are strided views (slice stride, row stride, unit k stride), so
// the hoisted recursions of ops/blocked.py pass sub-blocks of one shared
// peel without a copy. The 16-byte copies need every row to start on a
// 16-byte boundary: the wrapper copies an operand that does not into an
// aligned buffer first, and this entry point refuses one.
//
// mm_groups_f64 replaces no TPU kernel: the JAX package leaves the f64
// epilogue to XLA, which fuses it; eagerly it was three torch passes and
// the caller's update (ops/ozaki.py matmul_presplit), which with the
// peel's set the d tier's pace on the host. It is the same kernel with
// another store: each element's renormalized pair, as mm_groups_f32pair
// stores it, becomes
//     out[i, j] = beta·out[i, j] + alpha·(((f64)hi + (f64)lo)·ascale_i)·bscale_j
// in that order, every operation an f64 intrinsic that rounds to nearest,
// so the result is bit for bit that of the torch passes; beta 0 reads
// nothing of out, beta 1 and alpha 1 multiply by nothing. out is any
// strided f64 view whose elements do not overlap. The last warpgroup
// leaves its pair in shared memory like the others, and after the barrier
// every thread takes elements along the tile's rows (32 neighbouring
// doubles a warp): the f64 work beside the live int32 sums spilled at
// S = 5, 6, and the f32 pair's store pattern would scatter the f64 one.
#include <cstdint>

#include "sgemm_tile.cuh"  // CT_EXPORT

namespace {

constexpr int BM = 64;            // output tile rows: the M of one wgmma
constexpr int BK = 32;            // k-step: the depth of one wgmma
constexpr int WG = 128;           // threads of a warpgroup
constexpr int MAX_SLICES = 8;
constexpr int KCHUNK = 32768;     // 8 · 65² · 32768 < 2^31
constexpr int A_SLICE = BM * BK;  // one staged slice of A's rows, bytes

// The tile is BM x BN, BN = 64 or 128 (the N of one wgmma): int32 sums
// per thread per group, bytes of one staged k-step, of the (hi, lo) pair
// tile, and the ring's depth, as deep as shared memory allows.
template <int BN> constexpr int kAcc = BM * BN / WG;
template <int BN> constexpr int kPairBytes = 2 * kAcc<BN> * WG * 4;
template <int BN>
__host__ __device__ constexpr int stage_bytes(int S) {
  return S * (A_SLICE + BN * BK);
}
template <int BN>
__host__ __device__ constexpr int stages() { return BN == 64 ? 5 : 4; }
template <int BN>
constexpr int smem_bytes(int S) {
  return stages<BN>() * stage_bytes<BN>(S) + kPairBytes<BN> + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A staged slice is its rows' 32 bytes of one k-step, row r at r·32
// bytes with its two 16-byte halves swapped in rows with r & 4: wgmma's
// 32-byte swizzle, under which the 8 rows of a 16-byte column fall in 8
// different bank groups.
__device__ __forceinline__ int staged_offset(int row, int kh) {
  return row * BK + ((kh ^ ((row >> 2) & 1)) << 4);
}

// wgmma shared-memory descriptor of one staged slice (K-major): start
// address and stride byte offset (8 rows of 32 bytes) in 16-byte units,
// the leading offset unused (1), the 32-byte swizzle (3) in bits 62-63.
__device__ __forceinline__ uint64_t slice_desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{256 >> 4} << 32) | (uint64_t{3} << 62);
}

// Stage k-step [k0, k0 + BK) of the S slices of the R rows x0.. of X
// (rows past lim and bytes past kend read as zero) into st, slice s at
// st + s·R·BK, row r's 16-byte half kh at + staged_offset(r, kh).
template <int R>
__device__ __forceinline__ void load_slices(unsigned char* st,
                                            const signed char* X,
                                            long long ss, long long sr, int S,
                                            int x0, int lim, int k0,
                                            int kend) {
  for (int c = threadIdx.x; c < S * R * 2; c += blockDim.x) {
    const int s = c / (R * 2), row = (c >> 1) % R, kh = c & 1;
    const int kc = k0 + kh * 16;
    const signed char* src = X;
    int bytes = 0;
    if (x0 + row < lim && kc < kend) {
      bytes = min(16, kend - kc);
      src += s * ss + (x0 + row) * sr + kc;
    }
    const uint32_t dst = smem_u32(st + s * R * BK + staged_offset(row, kh));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  }
}

// One k-step of both operands: A's S slices, then B's.
template <int BN>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const signed char* __restrict__ A, long long sa_s,
    long long sa_r, const signed char* __restrict__ B, long long sb_s,
    long long sb_r, int S, int r0, int c0, int m, int n, int k0, int kend) {
  load_slices<BM>(st, A, sa_s, sa_r, S, r0, m, k0, kend);
  load_slices<BN>(st + S * A_SLICE, B, sb_s, sb_r, S, c0, n, k0, kend);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across the async wgmma
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d += A(64 x 32 s8, desc da) · B(BN x 32 s8, desc db)ᵀ, exact in int32
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc<BN>], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
  } else {
    static_assert(BN == 128, "wgmma N of 64 or 128");
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
}

// Where a tile's pair goes: the f32 (hi, lo) pair, stored by the last
// warpgroup from its registers ...
struct PairStore {
  static constexpr bool kStaged = false;
  float* hi;
  float* lo;
  long long ldc;
  __device__ __forceinline__ void operator()(int r, int c, float h,
                                             float l) const {
    hi[r * ldc + c] = h;
    lo[r * ldc + c] = l;
  }
};

// ... or out := beta·out + alpha·(((f64)h + (f64)l)·ascale_r)·bscale_c,
// stored by every thread from the pair in shared memory once the int32
// sums are dead
struct F64Store {
  static constexpr bool kStaged = true;
  double* out;
  long long so0, so1;
  const double* ascale;
  const double* bscale;
  double alpha, beta;
  __device__ __forceinline__ void operator()(int r, int c, float h,
                                             float l) const {
    double v = __dmul_rn(
        __dmul_rn(__dadd_rn(static_cast<double>(h), static_cast<double>(l)),
                  ascale[r]),
        bscale[c]);
    if (alpha != 1.0) v = __dmul_rn(alpha, v);
    double* o = out + r * so0 + c * so1;
    if (beta != 0.0) v = __dadd_rn(beta == 1.0 ? *o : __dmul_rn(beta, *o), v);
    *o = v;
  }
};

// hi + lo += t exactly in hi (Knuth two-sum), the error rounded into lo.
__device__ __forceinline__ void two_sum_into(float& hi, float& lo, float t) {
  const float s = __fadd_rn(hi, t);
  const float z = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, z)), __fsub_rn(t, z));
  hi = s;
  lo = __fadd_rn(lo, e);
}

// hi + lo += 2^(-7(g+2))·G: G = 4096·ghi + glo, glo in [0, 4095], both
// halves and their products with the power-of-two weight exact in f32
__device__ __forceinline__ void absorb(float& hi, float& lo, int G, int g) {
  const float w = __int_as_float((127 - 7 * (g + 2)) << 23);
  const int ghi = G >> 12;                  // floor(G / 4096)
  const int glo = G - ghi * 4096;
  two_sum_into(hi, lo, __fmul_rn(__int2float_rn(ghi), __fmul_rn(4096.f, w)));
  two_sum_into(hi, lo, __fmul_rn(__int2float_rn(glo), w));
}

// The S + 1 products of warpgroup Q's groups Q and S-1-Q on one staged
// k-step, straight-line (a loop of run-time length between two wgmma
// would make ptxas serialize them).
template <int S, int BN, int Q>
__device__ __forceinline__ void issue(int (&acc0)[kAcc<BN>],
                                      int (&acc1)[kAcc<BN>], uint32_t sa,
                                      uint32_t sb) {
  constexpr int B_SLICE = BN * BK;
  constexpr int G0 = Q, G1 = S - 1 - Q;
#pragma unroll
  for (int s = 0; s <= G0; ++s)
    wgmma_s8<BN>(acc0, slice_desc(sa + s * A_SLICE),
                 slice_desc(sb + (G0 - s) * B_SLICE));
  if constexpr (G1 != G0) {
#pragma unroll
    for (int s = 0; s <= G1; ++s)
      wgmma_s8<BN>(acc1, slice_desc(sa + s * A_SLICE),
                   slice_desc(sb + (G1 - s) * B_SLICE));
  }
}

template <int S, int BN, class Store>
__global__ void __launch_bounds__((S + 1) / 2 * WG, 1)
mm_groups_kernel(const signed char* __restrict__ A, long long sa_s,
                 long long sa_r, const signed char* __restrict__ B,
                 long long sb_s, long long sb_r, const Store put, int m,
                 int n, int K) {
  constexpr int NWG = (S + 1) / 2;
  constexpr int NST = stage_bytes<BN>(S);
  constexpr int STAGES = stages<BN>();
  constexpr int ACC = kAcc<BN>;
  constexpr int AHEAD = STAGES - 2;    // k-steps loaded ahead of the one used
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the stages start on 1 KB, so every slice starts on a swizzle period
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const pair = reinterpret_cast<float*>(smem + STAGES * NST);
  // the warpgroup index through a shuffle from lane 0: ptxas then knows it
  // is the same for the whole warp, and the per-warpgroup products below
  // are no divergent path (which would make it serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int t = threadIdx.x % WG;
  const int g0 = wg, g1 = S - 1 - wg;     // g1 == g0: the middle, odd S
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const uint32_t sbase = smem_u32(smem);

  const int nchunks = max(1, (K + KCHUNK - 1) / KCHUNK);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int kc0 = ch * KCHUNK, kend = min(K, kc0 + KCHUNK);
    const int KT = (kend - kc0 + BK - 1) / BK;
    int acc0[ACC], acc1[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = acc1[i] = 0;

    // the ring: k-steps 0 .. AHEAD-1 in flight before the first product
#pragma unroll
    for (int p = 0; p < AHEAD; ++p) {
      if (p < KT)
        load_stage<BN>(smem + p * NST, A, sa_s, sa_r, B, sb_s, sb_r, S, r0,
                       c0, m, n, kc0 + p * BK, kend);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<AHEAD - 1>();      // this thread's copies of step kt
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // everyone's copies of step kt have landed, and every warpgroup's
      // products of step kt-2 are done (at most one batch stays in
      // flight), so step kt+AHEAD may overwrite that stage
      __syncthreads();
      const int nk = kt + AHEAD;
      if (nk < KT)
        load_stage<BN>(smem + (nk % STAGES) * NST, A, sa_s, sa_r, B, sb_s,
                       sb_r, S, r0, c0, m, n, kc0 + nk * BK, kend);
      cp_async_commit();

      const uint32_t sa = sbase + (kt % STAGES) * NST;
      const uint32_t sb = sa + S * A_SLICE;
      pin(acc0);
      pin(acc1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      switch (wg) {
        case 0: issue<S, BN, 0>(acc0, acc1, sa, sb); break;
        case 1:
          if constexpr (NWG > 1) issue<S, BN, 1>(acc0, acc1, sa, sb);
          break;
        case 2:
          if constexpr (NWG > 2) issue<S, BN, 2>(acc0, acc1, sa, sb);
          break;
        default:
          if constexpr (NWG > 3) issue<S, BN, 3>(acc0, acc1, sa, sb);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(acc0);
      pin(acc1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc0);
    pin(acc1);
    cp_async_wait<0>();

    // the warpgroups absorb their groups into the pair in turn; the last
    // one, at the last chunk, renormalizes (|lo| <= ulp(hi) / 2) and stores.
    // acc[i] of a thread is row 16·warp + lane/4 (+ 8 for i % 4 >= 2),
    // column 8·(i / 4) + 2·(lane % 4) + i % 2 of the tile.
    const bool last = ch == nchunks - 1;
    for (int q = 0; q < NWG; ++q) {
      if (wg == q) {
        const bool first = ch == 0 && q == 0;
        const bool store = !Store::kStaged && last && q == NWG - 1;
        const int lane = t % 32, warp = t / 32;
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          float h = first ? 0.f : pair[i * WG + t];
          float l = first ? 0.f : pair[(ACC + i) * WG + t];
          absorb(h, l, acc0[i], g0);
          if (g1 != g0) absorb(h, l, acc1[i], g1);
          if (!store) {
            pair[i * WG + t] = h;
            pair[(ACC + i) * WG + t] = l;
            continue;
          }
          const int r = r0 + 16 * warp + lane / 4 + ((i & 2) ? 8 : 0);
          const int c = c0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (r < m && c < n) {
            const float sum = __fadd_rn(h, l);
            put(r, c, sum, __fsub_rn(l, __fsub_rn(sum, h)));
          }
        }
      }
      __syncthreads();
    }
    if constexpr (Store::kStaged) {
      if (last) {
        // element (row, col) of the tile is acc[i] of thread slot, as above
        for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
          const int row = e / BN, col = e % BN;
          const int r = r0 + row, c = c0 + col;
          if (r < m && c < n) {
            const int rr = row % 16, cc = col % 8;
            const int slot = row / 16 * 32 + rr % 8 * 4 + cc / 2;
            const int i = col / 8 * 4 + rr / 8 * 2 + cc % 2;
            const float h = pair[i * WG + slot];
            const float l = pair[(ACC + i) * WG + slot];
            const float sum = __fadd_rn(h, l);
            put(r, c, sum, __fsub_rn(l, __fsub_rn(sum, h)));
          }
        }
      }
    }
  }
}

template <int S, int BN, class Store>
int launch(const signed char* A, long long sa_s, long long sa_r,
           const signed char* B, long long sb_s, long long sb_r,
           const Store& store, int m, int n, int k, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>(S);
  static_assert(smem <= 227 * 1024, "the ring must fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      mm_groups_kernel<S, BN, Store>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_groups_kernel<S, BN, Store><<<grid, (S + 1) / 2 * WG, smem, stream>>>(
      A, sa_s, sa_r, B, sb_s, sb_r, store, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long ss, long long sr) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && ss % 16 == 0 &&
         sr % 16 == 0;
}

// The checks both entry points share, then the launch for S and the tile:
// 64 x 128 tiles where a grid of 64 x 64 ones would fill the card twice
// over and the two groups' 128 int32 sums per thread leave room (S <= 6);
// 64 x 64 tiles elsewhere, so that a small product keeps its blocks
template <class Store>
int dispatch(const signed char* A, long long sa_s, long long sa_r,
             const signed char* B, long long sb_s, long long sb_r,
             const Store& store, int S, int m, int n, int k, int device,
             void* stream) {
  if (S < 1 || S > MAX_SLICES || m < 1 || n < 1 || k < 0 ||
      m > 65535 * BM || !aligned16(A, sa_s, sa_r) ||
      !aligned16(B, sb_s, sb_r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nsm = 0;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles64 = (long long)((m + BM - 1) / BM) * ((n + 63) / 64);
  const bool wide = S <= 6 && tiles64 >= 2LL * nsm;
  using Launch = int (*)(const signed char*, long long, long long,
                         const signed char*, long long, long long,
                         const Store&, int, int, int, cudaStream_t);
  constexpr Launch narrow_by_slices[MAX_SLICES] = {
      launch<1, 64, Store>, launch<2, 64, Store>, launch<3, 64, Store>,
      launch<4, 64, Store>, launch<5, 64, Store>, launch<6, 64, Store>,
      launch<7, 64, Store>, launch<8, 64, Store>};
  constexpr Launch wide_by_slices[6] = {
      launch<1, 128, Store>, launch<2, 128, Store>, launch<3, 128, Store>,
      launch<4, 128, Store>, launch<5, 128, Store>, launch<6, 128, Store>};
  return (wide ? wide_by_slices : narrow_by_slices)[S - 1](
      A, sa_s, sa_r, B, sb_s, sb_r, store, m, n, k,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

CT_EXPORT int ct_mm_groups_f32pair(const signed char* A, long long sa_s,
                                   long long sa_r, const signed char* B,
                                   long long sb_s, long long sb_r, float* hi,
                                   float* lo, long long ldc, int S, int m,
                                   int n, int k, int device, void* stream) {
  if (ldc < n) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(A, sa_s, sa_r, B, sb_s, sb_r, PairStore{hi, lo, ldc}, S, m,
                  n, k, device, stream);
}

CT_EXPORT int ct_mm_groups_f64(const signed char* A, long long sa_s,
                               long long sa_r, const signed char* B,
                               long long sb_s, long long sb_r,
                               const double* ascale, const double* bscale,
                               double* out, long long so0, long long so1,
                               double alpha, double beta, int S, int m, int n,
                               int k, int device, void* stream) {
  return dispatch(A, sa_s, sa_r, B, sb_s, sb_r,
                  F64Store{out, so0, so1, ascale, bscale, alpha, beta}, S, m,
                  n, k, device, stream);
}
