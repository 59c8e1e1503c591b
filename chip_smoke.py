#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's nineteen CUDA kernels from ``cholesky_tpu_torch/ops/
kernels/csrc``, holds each against its plain torch twin at the shapes its
path gives it (the device fills bit for bit at 8192², with their moments,
range, interval endpoints and seed decorrelation; the GP model's RBF
kernels at the GP cells' shapes, n = 8192, d = 8, m = 819: D bit for bit,
K within 2 ulps of the twin's, the gradient sums against the twin's and an
f64 evaluation), then drives the paths
below through the public API. Before
each path every launch counter is set to 0, and after it the counters must
show that the path went through each of its kernels:

- phase 4, the potrf path: ``potrf`` and ``logdet``, f32, n = 4096, 8192
  (one ``potrf_stream_f32`` launch each), then ``potrf`` with
  ``block_size=512`` at 4096 (the blocked recursion over 512 leaves);
- phase 5, the GP model: exact GP regression on n = 8192 points with d = 8
  features, three ``gp_train_step``s and one ``gp_predict`` (``rbf_f32``,
  potrf, trsm, potri = trtri then lauum, ``rbf_grad_f32``), held against
  an f64 ``torch.linalg`` oracle;
  then ``potri`` at n = 4096 and ``lauum`` with 512 leaves at 2048;
- phase 6, the d tier: ``dpotrf``, ``dlogdet`` and ``dpotri`` at n = 8192
  on an f64 cond-100 matrix under ``backend="auto"`` (the Ozaki int8 slice
  products, ``peel_f64`` and ``mm_groups_f64``, over the f32 leaf
  kernels), held in f64 against cuSOLVER's ``torch.linalg``, then a
  non-positive-definite input, the f64 rescue of a leaf, times beside
  cuSOLVER and a ``torch.profiler`` table of one ``dpotrf``;
- phase 7, the BLAS path, each call on its own counters: ``strmm`` at
  n = m = 8192 in six forms (one ``trmm_lln_f32`` launch each, no
  ``gemm_f32``), ``sgemm`` 8192³ and ``ssyrk`` n = k = 8192, ``dtrmm`` at
  8192 under ``auto`` (the Ozaki kernels only), ``spotf2`` at n = 16384
  (one ``potf2_f32`` launch, above the whole-matrix kernels' 8192 cap),
  ``strtri(block_size=8192)`` at 8192 (one launch of the kernel the
  tuning table routes the block to: ``trtri_stream_f32`` where
  ``trtri_f32.mega_max_n`` reaches 8192, else ``trti2_f32``) and
  ``strtri(block_size=8320)`` at 8320 (one ``trti2_f32`` launch: no
  whole-matrix kernel takes a block past 8192), unit and not, each
  held in f64 and timed beside one PyTorch call;
- phase 8, the c/z tier through the real embedding at n = 4096 complex
  (8192 real) on cond-100 HPD inputs: ``zpotrf``, ``zlogdet`` and
  ``zpotri`` on an (re, im) pair under ``auto`` (the Ozaki kernels and the
  f32 leaves only), ``cpotrf`` (one ``potrf_stream_f32`` launch),
  ``clogdet`` and ``cpotri`` on a c64 tensor, a non-HPD input's ``info``
  against cuSOLVER's, ``ztrsm``/``ctrsm`` on right-hand sides made by the
  device fills as (re, im) pairs, and ``cgemm``, ``cherk`` and ``ctrmm``
  at 2048 (``gemm_f32`` only), each held in c128 on the card and timed
  beside a c64/c128 ``torch.linalg`` or ``matmul`` call;
- phase 9, the headline bench: ``bench_torch.py``'s ladder (spotrf at
  1024-24576, each factor verified) and its JSON line;
- phase 10, the block-cyclic tier (``cholesky_tpu_torch.parallel``) on a
  one-rank NCCL group: ``potrf_sharded`` and ``logdet_dist`` at
  n = 16384, nb = 256 with lookahead (``potrf_block_f32`` and
  ``trtri_block_f32`` once per block, ``gemm_f32``, no
  ``potrf_stream_f32``), ``trsm_factor_dist`` N and T with 16
  right-hand sides, ``potri_sharded`` at 8192, f64 ``potrf_sharded`` at
  4096 under ``auto`` (the Ozaki kernels) and a non-PD f32 input, each
  with its collective counts and timed beside ``ct.potrf``/``ct.logdet``/
  ``ct.potri`` and cuSOLVER. One card: no scaling is measured.
- phase 11, the multi-device tier's part (b) on a one-rank NCCL group:
  the distributed GP train step (``models/gp_dist.py`` on
  ``launch.mesh2d(1, 1)``) at n_train = 8192, d = 8, batch 2, nb = 256, 2
  probes, its nll and gradients held against the same Hutchinson
  estimator in f64 and three steps on their own counters
  (``potrf_block_f32`` and ``trtri_block_f32`` once per block per
  problem, ``gemm_f32``, no ``potrf_stream_f32``; the collective census),
  timed beside ``ct.potrf`` + two ``ct.trsm`` and profiled; one call of
  each distributed BLAS routine (``parallel/blas.py``): f32 ``gemm_dist``
  8192³, ``syrk_dist``, ``trsm_dist`` and ``trmm_dist`` at 8192, f64
  ``gemm_dist``/``trsm_dist``/``trmm_dist`` at 4096 (the Ozaki kernels)
  and c64 ``herk_dist`` at 4096, each on its own counters (one
  all_gather a call), gated in f64 and timed beside the single-device
  call and one torch call; then the dry run
  (``entry.dryrun_multichip(1)``, one spawned NCCL rank) and
  ``entry.entry()``'s forward.
- phase 12, the tooling (``utils/profiling.py``, ``runtime/``,
  ``tools/``): a ``profiling.trace`` of one ``potrf`` at 4096 inside an
  ``annotate`` span, in a fresh process (the Chrome trace names
  ``potrf_stream_f32``'s kernel and the span; ``profiling.device_time``
  counts its one launch); four
  numpy f64 oracles on ``TaskPool(4)`` while ``gemm_f32`` runs at 4096³,
  each equal to a serial run; the sweep in-process over all eleven ops
  (s at 512 and 1024, d/c/z at 256 and 512), every row passed and naming
  the card, with the launches of each point by kernel
  (``sweep_kernels``); minibench's probes, its f32 matmul at or below
  the FFMA peak and its HBM rate at or below 3350 GB/s; ``report --md``
  over the committed ``bench_results/golden_h100_*.jsonl``.

The kernels of ``strtri(block_size=8192)``, ``potri`` at 6000 and
``cpotri`` depend on the tuning table in force (``routed_paths``), which
is printed first, with the routes it gives those paths.

Phase 3 also runs the A/B of ``gemm_f32``'s two tiles at the paths'
shapes, of ``potrf_block_f32``'s two launches (one thread block, or one
cooperative launch over many) and of ``potrf_stream_f32`` at the
multiples of 128 that sets its crossover, of ``potf2_f32``'s strip
width at 16384 and of ``syrk_lower_f32``'s cuts of the depth at 512,
1024 and 2048, of ``lauum_stream_f32``'s equal runs against a tile a
block at 1024-8192, of ``lauu2_f32``'s plans (its rule, runs for one
wave or one block an SM, a tile a block) at 128-2048, and of the tile
count from which ``trtri_stream_f32``'s levels take a block a tile, at
2048, 4096 and 8192; holds ``lauu2_f32`` on dense factors at n = 1-2048
(contiguous and views on and off the 16-byte grid, a NaN strict upper
of many payloads passed through bit for bit, repeats bit for bit, one
launch counted a call) and times it (call, host enqueue and device
time) beside ``torch.matmul(Lᵀ, L)`` and, at 2048, ``lauum_stream_f32``;
drives ``lauum(block_size=2048)`` at 4096 (two ``lauu2_f32`` launches)
and ``potri`` at 6000 (no ``lauu2_f32`` launch: its padded working copy
goes to the whole-matrix kernels); times ``trti2_f32`` beside
``trtri_stream_f32`` at 1152-8192 and the public ``trtri`` at 8192 (on
the tuning table's route, and under a 4096 cap) beside one
``trtri_stream_f32`` launch; and prints the traces of
``potrf_stream_f32``'s panel loop at n = 1024, 4096 and 8192 (per phase
the sum over panels, F's mean, the first panel whose F is not hidden
behind the trailing update) and of ``trtri_stream_f32``'s phases at
2048, 4096 and 8192. Phase 5 counts every ``gemm_f32`` launch of one GP
train step by shape and layout, with the tile the launch rule chose and
its device time, and its ``trtri_block_f32``, ``trtri_stream_f32`` and
``lauum_stream_f32`` launches with their device time; phase 6 every
``mm_groups_f64`` launch of the profiled ``dpotrf``.

Every check raises on failure, so the script exits non-zero and prints no
result line. Needs one CUDA card; imports nothing of JAX.

The last two lines of standard output are one JSON object per kernel
({"kernels": [...]}, each with the path its launch count comes from, its
launches on every path that ran it, its bound at the H100's published
peaks and the time of one PyTorch library call computing the same
function where there is one) and the result {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import sys
import time

import torch
import torch.distributed as dist

import bench_torch
import cholesky_tpu_torch as ct
from cholesky_tpu_torch import parallel as par
from cholesky_tpu_torch.models import gp
from cholesky_tpu_torch.ops import blocked, kernels, ozaki
from cholesky_tpu_torch.ops.kernels import _build, leaf, mega, rbf
from cholesky_tpu_torch.ops.kernels import gemm as kgemm
from cholesky_tpu_torch.ops.kernels import syrk as ksyrk
from cholesky_tpu_torch.ops.kernels.gemm import gemm_f32, gemm_plain
from cholesky_tpu_torch.ops.kernels.leaf import (lauu2_f32, lauu2_plain,
                                                 potf2_f32, potf2_plain,
                                                 trti2_f32, trti2_plain,
                                                 unit_inverse)
from cholesky_tpu_torch.ops.kernels.mega import (lauum_stream_f32,
                                                 lauum_stream_plain,
                                                 potrf_block_f32,
                                                 potrf_block_plain,
                                                 potrf_stream_f32,
                                                 potrf_stream_plain,
                                                 trtri_block_f32,
                                                 trtri_block_plain,
                                                 trtri_stream_f32,
                                                 trtri_stream_plain)
from cholesky_tpu_torch.ops.kernels.ozaki import (epilogue_plain,
                                                  mm_groups_f32pair,
                                                  mm_groups_f64,
                                                  mm_groups_plain,
                                                  peel_f32pair, peel_f64,
                                                  peel_f64_plain, peel_plain,
                                                  scaled_pair)
from cholesky_tpu_torch.ops.kernels.prng import (uniform_fill_f32,
                                                 uniform_fill_f32_plain,
                                                 uniform_fill_f64,
                                                 uniform_fill_f64_plain)
from cholesky_tpu_torch.ops.kernels.syrk import (syrk_lower_f32,
                                                 syrk_lower_plain)
from cholesky_tpu_torch.ops.kernels.trmm import trmm_lln_f32, trmm_lln_plain
from cholesky_tpu_torch.parallel import comm as par_comm
from cholesky_tpu_torch.parallel import launch
from cholesky_tpu_torch.rng import (Interval, latmc, latmc_pair,
                                    uniform_device, uniform_device64)
from cholesky_tpu_torch.rng import device as rng_device
from cholesky_tpu_torch.tuning import DEFAULTS, get_params
from cholesky_tpu_torch.tuning.autotune import standing_in
from cholesky_tpu_torch.utils import profiling
from cholesky_tpu_torch.utils.benchlib import bench_op, card
from cholesky_tpu_torch.utils.profiling import busy_ms

EPS32 = float(torch.finfo(torch.float32).eps)
#: the H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W):
#: FP32 outside the tensor cores (TF32 is not f32-accurate), int8 on the
#: tensor cores, and HBM3
PEAK_OPS = {"f32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def flops_potrf(n: int) -> float:
    """The reference's spotrf flop count (bench.py)."""
    return n ** 3 / 3 + n ** 2 / 2 + n / 6


def bound(fpe: float, scale: float) -> float:
    """The repo's analytic tolerance: fpe x 2 x eps x max(1, scale)."""
    return fpe * 2.0 * EPS32 * max(1.0, scale)


def roofline(ops: float, kind: str, nbytes: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its operations over the peak rate of their type and the bytes it
    must move (each input read once, each output written once) over the
    memory rate; bound_by says which."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def tri_bytes(n: int, size: int = 4) -> int:
    """Bytes of one triangle of an n×n matrix, diagonal included."""
    return n * (n + 1) // 2 * size


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    if a.is_complex() or b.is_complex():
        a, b = a.to(torch.complex128), b.to(torch.complex128)
    else:
        a, b = a.double(), b.double()
    return float((a - b).abs().max())


def spd(gen, n: int, cond: float = 100.0):
    return latmc(gen, n, cond, torch.float32)


def dense_spd(gen, n: int, cond: float = 100.0):
    """A dense SPD f32 matrix: G·Gᵀ/n + s·I, G Gaussian, whose eigenvalues
    fill [s, 4 + s] (Marchenko-Pastur), s set for a 2-norm condition
    number of about ``cond``. Every entry of its factor and of the
    factor's inverse is live (latmc's matrices are diagonal plus a rank-2
    part), so a wrong trailing update or fold moves entries of the size of
    the strict lower's RMS, far above rounding."""
    G = torch.randn(n, n, device="cuda", generator=gen)
    A = torch.matmul(G, G.T).div_(n)
    del G
    A.diagonal().add_(4.0 / (cond - 1.0))
    return 0.5 * (A + A.T)


#: the leaf kernels' accuracy gate: the error against an f64 reference at
#: most this many times that of an f32 twin or library result on the same
#: input (and at least one ulp of max|ref|). Sound f32 results differ by a
#: few ulps; the script also requires the limit to lie below 1 % of the
#: RMS of the reference's strict lower, so that a wrong update or fold,
#: which moves entries by about that RMS, cannot pass.
F32_GATE = 8.0


def strict_rms(R) -> float:
    """RMS of the strict lower triangle of the square R."""
    n = R.shape[0]
    return float(torch.tril(R.double(), -1).square().sum().div(
        n * (n - 1) / 2).sqrt())


def gated(what, got, ref, f32_err, rms=None):
    """got against the f64 ``ref`` within F32_GATE times ``f32_err``, an
    f32 result's error against the same ref; the limit itself must sit
    below 1 % of ``rms`` (default: the RMS of ref's strict lower). Returns
    (err, limit, rms)."""
    err = max_err(got, ref)
    lim = F32_GATE * max(f32_err, EPS32 * float(ref.abs().max()))
    rms = strict_rms(ref) if rms is None else rms
    require(err <= lim, f"{what}: err {err:.3e} > {lim:.3e} ({F32_GATE:g}x "
            f"the f32 yardstick's {f32_err:.3e})")
    require(lim <= 1e-2 * rms, f"{what}: limit {lim:.3e} is not below 1 % "
            f"of the strict lower's RMS {rms:.3e}: the check is too weak")
    return err, lim, rms


def ms_inplace(fn, A, reps: int) -> float:
    """Median ms of the in-place ``fn`` on copies of A made before the
    clock starts (after one warm-up call), so no copy is timed."""
    copies = [A.clone() for _ in range(reps + 1)]
    fn(copies.pop())
    times = []
    for X in copies:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(X)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin at the main path's shapes
# ---------------------------------------------------------------------------

def gemm_tile_on(tile: int):
    """The gemm_f32 launch rule moved so that every launch takes the 128 or
    the 64 tile: GEMM128_MIN_TILES, its only selector, set for a while.
    Returns the value to put back."""
    keep = kgemm.GEMM128_MIN_TILES
    kgemm.GEMM128_MIN_TILES = 1 if tile == 128 else 1 << 30
    return keep


def operand(gen, rows, cols, transposed, off, odd):
    """A (rows x cols) f32 view of a wider buffer, row-major or (with
    ``transposed``) column-major, ``off`` elements past an aligned base
    (off the 16-byte grid when odd), the leading stride a multiple of 4 or,
    with ``odd``, odd."""
    inner, outer = (rows, cols) if transposed else (cols, rows)
    width = inner + off + 1
    width += (width % 2 == 0) if odd else -width % 4
    buf = torch.randn(outer, width, device="cuda", generator=gen)
    v = buf[:, off:off + inner]
    return v.T if transposed else v


def gemm_gated(what, got, A, B, C=None, alpha=1.0, beta=0.0):
    """gemm_f32's result against f64 within F32_GATE times torch.matmul's
    f32 error (cuBLAS, TF32 off) on the same operands."""
    ref = alpha * (A.double() @ B.double())
    yard = alpha * torch.matmul(A, B)
    if C is not None:
        ref = ref + beta * C.double()
        yard = yard + beta * C
    return gated(what, got, ref, max_err(yard, ref), rms=rms_of(ref))


def check_gemm(gen, rec, on):
    """gemm_f32 against f64, each case within F32_GATE times torch.matmul's
    f32 error on the same operands: on both tiles, the four layout pairs of
    A and B at a ragged 1000 x 777 · 515, on the 16-byte grid, one column
    off it and with an odd leading stride; beta = 1 in place on a view with
    a transposed B (the trsm update); the leaf product of the panel solve
    and potri's 4096³ products on views of one 8192 buffer. Then the two
    tiles' A/B at the path's shapes and the times beside torch.matmul."""
    m, n, k = 1000, 777, 515
    worst = {128: 0.0, 64: 0.0}
    for tile in (128, 64):
        keep = gemm_tile_on(tile)
        try:
            for a_t in (False, True):
                for b_t in (False, True):
                    for off, odd in ((0, False), (1, False), (0, True)):
                        A = operand(gen, m, k, a_t, off, odd)
                        B = operand(gen, k, n, b_t, off, odd)
                        plan = kgemm.launch_plan(m, n, A.stride(),
                                                 A.data_ptr(), B.stride(),
                                                 B.data_ptr())
                        require(plan[0] == tile
                                and plan[3] == (off == 0 and not odd),
                                f"gemm_f32 launch plan {plan}")
                        err, lim, _ = gemm_gated(
                            f"gemm_f32 {tile}-tile A{'T' if a_t else 'N'}"
                            f" B{'T' if b_t else 'N'} off {off} odd {odd}",
                            gemm_f32(A, B, alpha=0.5), A, B, alpha=0.5)
                        worst[tile] = max(worst[tile], err / lim)
            # the trsm update B2 -= X1·Mᵀ in place on a slice view
            buf = torch.randn(m, k + n + 1, device="cuda", generator=gen)
            M = torch.randn(n, k, device="cuda", generator=gen)
            X1, B2 = buf[:, :k], buf[:, k + 1:]
            C0, left = B2.clone(), buf[:, :k + 1].clone()
            gemm_f32(X1, M.T, B2, alpha=-1.0, beta=1.0, out=B2)
            err, lim, _ = gemm_gated(f"gemm_f32 {tile}-tile in place",
                                     B2, X1, M.T, C0, -1.0, 1.0)
            worst[tile] = max(worst[tile], err / lim)
            require(torch.equal(buf[:, :k + 1], left),
                    f"gemm_f32 {tile}-tile wrote outside out")
        finally:
            kgemm.GEMM128_MIN_TILES = keep
    print(f"gemm_f32 {m}x{n}·{k}, both tiles, the four layouts of A and B "
          f"on the 16-byte grid, one column off it and with an odd leading "
          f"stride, and beta=1 in place on a view: the worst error "
          f"{worst[128]:.3f} (128-tile) and {worst[64]:.3f} (64-tile) of the "
          f"limit, {F32_GATE:g}x torch.matmul's f32 error against f64")
    # the leaf product of the panel solve, X·Tᵀ with Tᵀ a transposed view
    X = torch.randn(4096, 512, device="cuda", generator=gen)
    T = torch.randn(512, 512, device="cuda", generator=gen)
    err, lim, _ = gemm_gated("gemm_f32 (4096x512)·(512x512)ᵀ", gemm_f32(X, T.T),
                             X, T.T)
    # trtri's recursion at 8192 under a 4096 cap (DEFAULTS; the GP step's
    # potri where no table raises the cap): M' = -W2·M·W1 on 4096 halves,
    # all three views of one 8192 buffer
    L = torch.randn(8192, 8192, device="cuda", generator=gen) / 64.0
    W2, M, W1 = L[4096:, 4096:], L[4096:, :4096], L[:4096, :4096]
    Mp = gemm_f32(W2, M)
    err3, lim3, _ = gemm_gated("gemm_f32 4096³ W2·M", Mp, W2, M)
    out = L[4096:, :4096]
    gemm_f32(Mp, W1, alpha=-1.0, out=out)
    err4, lim4, _ = gemm_gated("gemm_f32 4096³ -M'·W1 into a view", out, Mp,
                               W1, alpha=-1.0)
    print(f"gemm_f32 (4096x512)·(512x512)ᵀ: err {err:.3e} (limit {lim:.3e}); "
          f"4096³ on views of an 8192 buffer: W2·M {err3:.3e} (limit "
          f"{lim3:.3e}), -M'·W1 into the view M {err4:.3e} (limit "
          f"{lim4:.3e}), against f64")
    # the two tiles at the path's shapes, in turns 128, 64, 64, 128
    for (mm, nn, kk, bt) in ((4096, 512, 512, True), (2048, 512, 512, True),
                             (1024, 1024, 1024, False),
                             (1536, 1024, 1024, False),
                             (2048, 2048, 2048, False)):
        Am = torch.randn(mm, kk, device="cuda", generator=gen)
        Bm = (torch.randn(nn, kk, device="cuda", generator=gen).T if bt
              else torch.randn(kk, nn, device="cuda", generator=gen))
        t = []
        for tile in (128, 64, 64, 128):
            keep = gemm_tile_on(tile)
            try:
                t.append(bench_op(lambda a: gemm_f32(a, Bm), Am, reps=10)
                         * 1e3)
            finally:
                kgemm.GEMM128_MIN_TILES = keep
        tiles = -(-mm // 128) * -(-nn // 128)
        print(f"gemm_f32 A/B {mm}x{nn}·{kk}{'ᵀ' if bt else ''} ({tiles} "
              f"tiles of 128): 128-tile {t[0]:.4f}/{t[3]:.4f} ms, 64-tile "
              f"{t[1]:.4f}/{t[2]:.4f} ms; the rule takes "
              f"{128 if tiles >= kgemm.GEMM128_MIN_TILES else 64} on {on}")
    D = torch.empty(4096, 512, device="cuda")
    ms = bench_op(lambda x: gemm_f32(x, T.T, out=D), X) * 1e3
    plain_ms = bench_op(lambda x: gemm_plain(x, T.T, out=D), X) * 1e3
    lib_ms = bench_op(lambda x: torch.matmul(x, T.T, out=D), X) * 1e3
    print(f"gemm_f32 (4096x512)·(512x512)ᵀ: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms on {on}")
    ms = bench_op(lambda m: gemm_f32(W2, m), M, reps=10) * 1e3
    plain_ms = bench_op(lambda m: gemm_plain(W2, m), M, reps=10) * 1e3
    lib_ms = bench_op(lambda m: torch.matmul(W2, m), M, reps=10) * 1e3
    print(f"gemm_f32 4096³ on views: kernel {ms:.4f} ms "
          f"({2 * 4096 ** 3 / ms / 1e9:.1f} GF/s), plain {plain_ms:.4f} ms, "
          f"torch.matmul {lib_ms:.4f} ms on {on}")
    rec["gemm_f32"] = dict(max_abs_err=max(err3, err4), ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           **roofline(2 * 4096 ** 3, "f32", 3 * 4096 ** 2 * 4))
    del L, X, D


def syrk_plan_on(**plan):
    """The syrk_lower_f32 launch rule moved so that every launch takes a
    uniform split of each tile's depth or a number of blocks
    (``launch_plan``'s overrides): launch_plan, its only selector, wrapped
    for a while. Returns the rule to put back."""
    keep = ksyrk.launch_plan
    ksyrk.launch_plan = functools.partial(keep, **plan)
    return keep


def plan_name(plan):
    return "/".join(f"{k} {v}" for k, v in plan.items())


def syrk_case(gen, n, k, row_fast, off=0, odd=False, plan=None):
    """syrk_lower_f32(-1, A, 1, C) on A (n x k) from ``operand`` (row-fast:
    a transposed view) and C a view one column into a wider buffer, under
    the launch rule or a forced plan (``syrk_plan_on``): against f64, gated
    on the twin's f32 error; the strict upper of C and everything outside
    the view unchanged bit for bit, and a second call equal bit for bit.
    Returns (err, limit, the plan the launch took)."""
    A = operand(gen, n, k, row_fast, off, odd)
    buf = torch.randn(n, n + 3, device="cuda", generator=gen)
    C = buf[:, 1:1 + n]
    keep_buf = buf.clone()
    C0 = keep_buf[:, 1:1 + n]
    ref = torch.tril(C0.double() - A.double() @ A.double().T)
    yard = torch.tril(syrk_lower_plain(-1.0, A, 1.0, C0.clone()))
    keep = syrk_plan_on(**plan) if plan else None
    try:
        took = ksyrk.launch_plan(n, k, A.stride(), A.data_ptr())
        syrk_lower_f32(-1.0, A, 1.0, C)
        again = keep_buf.clone()
        syrk_lower_f32(-1.0, A, 1.0, again[:, 1:1 + n])
    finally:
        if keep:
            ksyrk.launch_plan = keep
    what = (f"syrk_lower_f32 n={n} k={k} {'row' if row_fast else 'k'}-fast"
            f" off {off} odd {odd} plan (q, blocks) {took[:2]}")
    require(torch.equal(buf, again), f"{what}: a second call differs")
    low = torch.ones(n, n, dtype=torch.bool, device="cuda").tril_()
    require(torch.equal(C[~low], C0[~low])
            and torch.equal(buf[:, 0], keep_buf[:, 0])
            and torch.equal(buf[:, 1 + n:], keep_buf[:, 1 + n:]),
            f"{what}: wrote the strict upper or outside the view")
    err, lim, _ = gated(what, torch.tril(C), ref, max_err(yard, ref))
    return err, lim, took


def check_syrk(gen, rec, on):
    """The lower-triangle update against f64, each case within F32_GATE
    times the twin's f32 error, on k-fast and row-fast operands: the
    recursion's n = k = 512, 1024, 2048 and the public 8192 under the
    launch rule; ragged n (600, 1000), a view off the 16-byte grid and one
    of odd leading stride, k < 16; uniform splits and runs for a number of
    blocks at a ragged size. Each call leaves the strict upper and
    everything outside C as it was, and repeats bit for bit. Then the A/B
    of the depth's cuts
    (uniform splits of each tile, runs for a number of blocks) at the
    recursion's shapes, and the times beside torch.addmm (whole
    square)."""
    worst = 0.0
    plans = set()
    cases = [(n, n, rf, 0, False, None) for n in (512, 1024, 2048, 8192)
             for rf in (False, True)]
    cases += [(n, k, rf, off, odd, None)
              for n, k in ((600, 600), (1000, 1000), (1000, 515), (300, 7))
              for rf in (False, True)
              for off, odd in ((0, False), (1, False), (0, True))]
    cases += [(1000, 777, rf, 1, False, plan) for rf in (False, True)
              for plan in (dict(split=1), dict(split=2), dict(split=3),
                           dict(split=8), dict(blocks=97), dict(blocks=264))]
    for n, k, rf, off, odd, plan in cases:
        err, lim, took = syrk_case(gen, n, k, rf, off, odd, plan)
        worst = max(worst, err / lim)
        plans.add(took[:2])
        if n == k == 2048 and not rf:
            err_2048 = err
    print(f"syrk_lower_f32, {len(cases)} cases (n = k = 512 to 8192, ragged "
          f"n, k < 16, views off the 16-byte grid or of odd leading stride, "
          f"k-fast and row-fast A, plans (q, blocks) {sorted(plans)}): the "
          f"worst error {worst:.3f} of the limit, {F32_GATE:g}x the twin's "
          "f32 error "
          "against f64; strict upper and the rest of the buffer unchanged, "
          "every call repeated bit for bit")
    # the A/B of the depth's cuts at the recursion's shapes, in turns
    ab = [dict(split=1), dict(split=2), dict(split=4), dict(blocks=132),
          dict(blocks=264), dict(blocks=528)]
    for n in (512, 1024, 2048):
        buf = torch.randn(n, 2 * n, device="cuda", generator=gen)
        A, C = buf[:, :n], buf[:, n:]
        t = {}
        for plan in ab + ab[::-1]:
            keep = syrk_plan_on(**plan)
            try:
                t.setdefault(plan_name(plan), []).append(bench_op(
                    lambda c: syrk_lower_f32(-1e-3, A, 1.0, c), C,
                    reps=20) * 1e3)
            finally:
                ksyrk.launch_plan = keep
        rule = ksyrk.launch_plan(n, n, A.stride(), A.data_ptr())
        print(f"syrk_lower_f32 A/B n=k={n}: "
              + ", ".join(f"{p} {v[0]:.4f}/{v[1]:.4f}" for p, v in t.items())
              + f" ms; the rule takes (q, blocks) {rule[:2]} on {on}")
    for n in (512, 1024, 2048, 8192):
        buf = torch.randn(n, 2 * n, device="cuda", generator=gen)
        A, C = buf[:, :n], buf[:, n:]
        reps = 20 if n < 8192 else 3
        ms = bench_op(lambda c: syrk_lower_f32(-1e-3, A, 1.0, c), C,
                      reps=reps) * 1e3
        plain_ms = bench_op(lambda c: syrk_lower_plain(-1e-3, A, 1.0, c), C,
                            reps=reps) * 1e3
        # the library call computes the whole square, twice the work
        lib_ms = bench_op(lambda c: torch.addmm(c, A, A.T, beta=1.0,
                                                alpha=-1e-3), C,
                          reps=reps) * 1e3
        rl = roofline(n * (n + 1) * n, "f32", n * n * 4 + 2 * tri_bytes(n))
        print(f"syrk_lower_f32 n=k={n}: kernel {ms:.4f} ms "
              f"({n * (n + 1) * n / ms / 1e9:.1f} TF/s on the triangle), "
              f"plain {plain_ms:.4f} ms, torch.addmm (whole square) "
              f"{lib_ms:.4f} ms, bound {rl['bound_ms']:.4f} ms on {on}")
        if n == 2048:
            rec["syrk_lower_f32"] = dict(max_abs_err=err_2048, ms=ms,
                                         plain_ms=plain_ms,
                                         library_ms=lib_ms, **rl)
        del buf, A, C


def potrf_block_on(A, many: bool):
    """potrf_block_f32 on one thread block or on many, whatever n: the
    crossover POTRF_BLOCK_MULTI_MIN_N, its only selector, is moved for the
    one call."""
    keep = mega.POTRF_BLOCK_MULTI_MIN_N
    mega.POTRF_BLOCK_MULTI_MIN_N = 1 if many else mega.MAX_N + 1
    try:
        return potrf_block_f32(A)
    finally:
        mega.POTRF_BLOCK_MULTI_MIN_N = keep


def check_potrf_block(gen, rec, on):
    """Both launches (one thread block, and one cooperative launch over
    many) on views of a wider buffer whose strict upper holds NaN, ragged
    sizes included, against an f64 factor of a dense SPD input, gated on
    the twin's error; the A/B of the two launches and of potrf_stream_f32
    at the multiples of 128 that sets POTRF_BLOCK_MULTI_MIN_N; failed
    pivots in the first, a later and the last panel, and NaN pivots, the
    leading block gated the same way; the times of the default launch at
    128, 512 and 1024 beside cuSOLVER's cholesky_ex."""
    for n in (128, 200, 512, 777, 1024):
        # a diagonal block of the recursion: a view with a longer row
        A0 = dense_spd(gen, n)
        want = A0.clone()
        i_ref = potrf_block_plain(want)
        L64 = torch.linalg.cholesky(A0.double())
        twin_err = max_err(want, L64)
        errs = []
        for many in (False, True):
            what = f"potrf_block_f32 n={n} {'many' if many else 'one'}"
            buf = torch.zeros(n, 2 * n, device="cuda")
            blk = buf[:, n // 2:n // 2 + n]
            blk.copy_(A0)
            blk[torch.ones_like(blk, dtype=torch.bool).triu(1)] = math.nan
            info = potrf_block_on(blk, many)
            require(int(info) == 0 and int(i_ref) == 0,
                    f"{what}: info {int(info)}/{int(i_ref)}")
            err, lim, rms = gated(what, blk, L64, twin_err)
            require(bool((torch.triu(blk, 1) == 0).all()),
                    f"{what}: strict upper not zero")
            require(bool((buf[:, :n // 2] == 0).all()
                         and (buf[:, n // 2 + n:] == 0).all()),
                    f"{what}: wrote outside the view")
            errs.append(err)
        print(f"potrf_block_f32 n={n} (dense, cond 100) on a view, NaN strict "
              f"upper: max err vs f64 one block {errs[0]:.3e}, many "
              f"{errs[1]:.3e}, the twin's {twin_err:.3e} (limit {lim:.3e}, "
              f"1/{rms / lim:.0f} of the strict lower's RMS {rms:.3e})")
        if n == 1024:
            err_1024 = max(errs)
        del buf, L64
    # the A/B of the two launches and of potrf_stream_f32 (multiples of
    # 128), in turns: one, many, stream, stream, many, one
    for n in (128, 256, 512, 768, 1024):
        A0 = dense_spd(gen, n)
        fns = (lambda a: potrf_block_on(a, False),
               lambda a: potrf_block_on(a, True), potrf_stream_f32)
        t = [ms_inplace(fns[i], A0, 20) for i in (0, 1, 2, 2, 1, 0)]
        print(f"potrf_block_f32 A/B n={n}: one block {t[0]:.4f}/{t[5]:.4f} "
              f"ms, many {t[1]:.4f}/{t[4]:.4f} ms; potrf_stream_f32 "
              f"{t[2]:.4f}/{t[3]:.4f} ms on {on}")
    # failed pivots: info, nothing non-finite but an input NaN pivot, the
    # leading block against its f64 factor, gated on the twin's; the first
    # panel, a later one, the last one
    for n, k, v in ((256, 4, -1.0), (1024, 100, -1.0), (1024, 1000, -1.0),
                    (777, 776, -1.0), (256, 7, math.nan), (512, 300, math.nan)):
        A0 = dense_spd(gen, n, 10.0)
        A0[k, k] = v
        L64 = torch.linalg.cholesky(A0[:k, :k].double())
        want = A0.clone()
        i_ref = potrf_block_plain(want)
        twin_err = max_err(torch.tril(want[:k, :k]), L64)
        for many in (False, True):
            what = (f"potrf_block_f32 n={n} A[{k},{k}]={v} "
                    f"{'many' if many else 'one'}")
            A = A0.clone()
            info = potrf_block_on(A, many)
            bad = (~torch.isfinite(A)).nonzero().tolist()
            require(int(info) == k + 1 == int(i_ref)
                    and all(ix == [k, k] for ix in bad),
                    f"{what}: info {int(info)}, non-finite at {bad[:5]}")
            gated(f"{what}: leading block", torch.tril(A[:k, :k]), L64,
                  twin_err)
    print("potrf_block_f32 failed pivots A[4,4]=-1 (n=256), A[100,100] and "
          "A[1000,1000]=-1 (n=1024), A[776,776]=-1 (n=777), NaN at [7,7] "
          "(n=256) and [300,300] (n=512), dense, both launches: info k+1, "
          "nothing but an input NaN pivot non-finite, each leading block "
          "within the gate")
    # times of the default launch beside cuSOLVER
    for n in (128, 512, 1024):
        A0 = dense_spd(gen, n)
        ms = ms_inplace(potrf_block_f32, A0, 20)
        lib_ms = bench_op(lambda a: torch.linalg.cholesky_ex(a), A0,
                          reps=20) * 1e3
        plain_ms = bench_op(lambda a: potrf_block_plain(a.clone()), A0,
                            warmup=1, reps=3) * 1e3
        rl = roofline(n ** 3 / 3, "f32", 2 * tri_bytes(n))
        launch = ("many blocks" if n >= mega.POTRF_BLOCK_MULTI_MIN_N
                  else "one block")
        print(f"potrf_block_f32 n={n} ({launch}): "
              f"kernel {ms:.4f} ms, torch.linalg.cholesky_ex {lib_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {rl['bound_ms']:.4f} ms "
              f"({rl['bound_by']}) on {on}")
        if n == 1024:
            rec["potrf_block_f32"] = dict(
                max_abs_err=err_1024, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **rl)


def check_potrf_stream(gen, rec, on):
    """potrf_stream_f32 against an f64 factor of a dense SPD input, gated on
    its twin's error: n = 1152-8192 with a NaN strict upper, a view whose
    base and leading stride are off the 16-byte grid, failed pivots in the
    first, a middle and the last panel and a NaN pivot, each leading block
    gated the same way; then the time at 8192 beside cuSOLVER and the
    trace of the panel loop."""
    for n in (1152, 2048, 4096, 8192):
        A0 = dense_spd(gen, n)
        L64 = torch.linalg.cholesky(A0.double())
        want = A0.clone()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        i_ref = potrf_stream_plain(want)
        t1.record()
        t1.synchronize()
        twin_err = max_err(want, L64)
        del want
        # the caller's strict upper holds NaN: only the lower may be read
        F = A0.clone()
        F[torch.ones_like(F, dtype=torch.bool).triu(1)] = math.nan
        info = potrf_stream_f32(F)
        what = f"potrf_stream_f32 n={n}"
        require(int(info) == 0 and int(i_ref) == 0,
                f"{what}: info {int(info)}/{int(i_ref)}")
        require(bool(torch.isfinite(F).all())
                and bool((torch.triu(F, 1) == 0).all()),
                f"{what}: read the NaN strict upper or left it")
        err, lim, rms = gated(what, F, L64, twin_err)
        print(f"{what} (dense, cond 100), NaN strict upper: max err vs f64 "
              f"{err:.3e}, the twin's {twin_err:.3e} (limit {lim:.3e}, "
              f"1/{rms / lim:.0f} of the strict lower's RMS {rms:.3e})")
        del F, L64
        if n == 8192:
            plain_ms = t0.elapsed_time(t1)
            ms = ms_inplace(potrf_stream_f32, A0, 10)
            lib_ms = ms_inplace(torch.linalg.cholesky_ex, A0, 10)
            print(f"potrf_stream_f32 n={n}: kernel {ms:.4f} ms, "
                  f"torch.linalg.cholesky_ex {lib_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (one run) on {on}")
            rec["potrf_stream_f32"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **roofline(n ** 3 / 3, "f32", 2 * tri_bytes(n)))
        del A0
    # a view one column into a buffer of odd row length: base and leading
    # stride off the 16-byte grid; nothing outside the view written
    n = 2048
    A0 = dense_spd(gen, n)
    L64 = torch.linalg.cholesky(A0.double())
    want = A0.clone()
    potrf_stream_plain(want)
    buf = torch.full((n, n + 3), 7.0, device="cuda")
    v = buf[:, 1:1 + n]
    v.copy_(A0)
    v[torch.ones_like(v, dtype=torch.bool).triu(1)] = math.nan
    require(int(potrf_stream_f32(v)) == 0, "potrf_stream_f32 view: info")
    err, lim, _ = gated(f"potrf_stream_f32 n={n} view, leading stride "
                        f"{n + 3}", v, L64, max_err(want, L64))
    require(bool((buf[:, 0] == 7.0).all() and (buf[:, 1 + n:] == 7.0).all()),
            "potrf_stream_f32 wrote outside the view")
    print(f"potrf_stream_f32 n={n} on a view off the 16-byte grid (base one "
          f"column in, leading stride {n + 3}): max err vs f64 {err:.3e} "
          f"(limit {lim:.3e}), nothing outside the view written")
    del buf, v, want, L64
    # failed pivots in the first, a middle and the last panel, and a NaN
    # pivot: info, frozen and finite but an input NaN at its own place, the
    # leading block gated on the twin's
    for n, k, val in ((2048, 5, -1.0), (2048, 1000, -1.0), (2048, 2040, -1.0),
                      (1152, 7, math.nan)):
        A0 = dense_spd(gen, n, 10.0)
        A0[k, k] = val
        L64 = torch.linalg.cholesky(A0[:k, :k].double())
        want = A0.clone()
        i_ref = potrf_stream_plain(want)
        A = A0.clone()
        info = potrf_stream_f32(A)
        bad = (~torch.isfinite(A)).nonzero().tolist()
        what = f"potrf_stream_f32 n={n} A[{k},{k}]={val}"
        require(int(info) == k + 1 == int(i_ref)
                and all(ix == [k, k] for ix in bad),
                f"{what}: info {int(info)}, non-finite at {bad[:5]}")
        gated(f"{what}: leading block", torch.tril(A[:k, :k]), L64,
              max_err(torch.tril(want[:k, :k]), L64))
    print("potrf_stream_f32 failed pivots A[5,5], A[1000,1000], "
          "A[2040,2040]=-1 (n=2048: the first, a middle and the last panel) "
          "and a NaN pivot A[7,7] (n=1152), dense: info k+1, nothing but an "
          "input NaN pivot non-finite, each leading block within the gate")
    trace_potrf_stream(gen, on)


def stream_trace(A0):
    """One traced potrf_stream_f32 launch on a copy of A0 (after one
    untraced warm-up): its stamps in µs from the launch's start, one row
    per phase 0 and per panel (mega.STREAM_TRACE_SLOTS columns), and the
    grid size."""
    n = A0.shape[0]
    potrf_stream_f32(A0.clone())
    tr = torch.zeros(n // mega.NB, mega.STREAM_TRACE_SLOTS, dtype=torch.int64,
                     device="cuda")
    A = A0.clone()
    torch.cuda.synchronize()
    require(int(potrf_stream_f32(A, trace=tr)) == 0, "traced launch: info")
    t = tr.cpu()
    grid = int(t[0, 1])
    t[0, 1] = t[0, 0]
    return (t - t[0, 0]).double() / 1e3, grid


def trace_potrf_stream(gen, on, sizes=(1024, 4096, 8192)):
    """The panel loop of potrf_stream_f32 from its trace: per phase the sum
    over panels (S: block 0's entry to the last block's arrival at the
    sync; U: the sync's exit to the last updating block's end; F exposed:
    block 0's end of F beyond that; each sync: its exit after the last
    arrival), F's mean and the first panel whose F is not hidden behind
    U. Returns {n: (total µs, F mean µs)}."""
    out = {}
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for n in sizes:
        t, grid = stream_trace(dense_spd(gen, n))
        f0 = t[0]
        p = t[1:]                       # panel rows
        s = (p[:, 1] - p[:, 0]).sum()
        sync1 = (p[:, 2] - p[:, 1]).sum()
        diag = (p[:, 3] - p[:, 2]).sum()
        fac = (p[:, 4] - p[:, 3]).sum()
        inv = (p[:, 5] - p[:, 4]).sum()
        u = (p[:, 6] - p[:, 2]).sum()
        exposed = (p[:, 5] - p[:, 6]).clamp(min=0)
        sync2 = (p[:, 7] - torch.maximum(p[:, 5], p[:, 6])).sum()
        total = float(p[-1, 7]) if len(p) else float(f0[7])
        f_mean = float(((p[:, 5] - p[:, 3]).sum() + f0[5] - f0[3])
                       / (len(p) + 1))
        late = (exposed > 0).nonzero()
        first = int(late[0]) if len(late) else None
        print(f"potrf_stream_f32 trace n={n}, grid {grid} ({grid / nsm:g} "
              f"per SM x {nsm} SMs), {len(p)} panels: total {total:.1f} µs; "
              f"phase 0 {float(f0[7]):.1f} (F(0) factor "
              f"{float(f0[4] - f0[3]):.1f}, inverse {float(f0[5] - f0[4]):.1f}"
              f"); sums over panels: S {float(s):.1f}, sync after S "
              f"{float(sync1):.1f}, U (last block) {float(u):.1f}, block 0's "
              f"diagonal update {float(diag):.1f}, factor {float(fac):.1f}, "
              f"inverse {float(inv):.1f}, F exposed beyond U "
              f"{float(exposed.sum()):.1f}, sync after U {float(sync2):.1f}; "
              f"F (factor + inverse) mean {f_mean:.2f} µs; F exposed from "
              f"panel {first} on ({len(late)} panels) on {on}")
        out[n] = (total, f_mean)
    return out


def trtri_gated(what, W, L, rms=None):
    """W against the f64 inverse of tril(L), gated on the f32
    solve_triangular(L, I)'s error (for n = 1, whose strict lower is
    empty, within the gate's multiple of an ulp only)."""
    n = L.shape[0]
    eye = torch.eye(n, device="cuda")
    W64 = torch.linalg.solve_triangular(torch.tril(L).double(), eye.double(),
                                        upper=False)
    yard = max_err(torch.linalg.solve_triangular(torch.tril(L), eye,
                                                 upper=False), W64)
    if n == 1:
        err = max_err(W, W64)
        lim = F32_GATE * max(yard, EPS32 * float(W64.abs().max()))
        require(err <= lim, f"{what}: err {err:.3e} > {lim:.3e}")
        return err, lim, 0.0, yard
    return (*gated(what, W, W64, yard, rms), yard)


def check_trtri_block(gen, rec, on):
    """The block recursion against an f64 inverse of a dense factor, gated
    on solve_triangular's f32 error, at ragged n (split points at
    multiples of 128, the last block short) with a NaN strict upper; zero
    diagonals, the unit route and a view with a longer row; the times at
    128, 512 and 1024 beside solve_triangular(L, I)."""
    for n in (1, 31, 32, 33, 100, 128, 500, 512, 1000, 1024):
        L = torch.linalg.cholesky(dense_spd(gen, n)).contiguous()
        X = L.clone()
        X[torch.ones_like(X, dtype=torch.bool).triu(1)] = math.nan
        W, info = trtri_block_f32(X)
        what = f"trtri_block_f32 n={n}"
        require(int(info) == 0 and bool((torch.triu(W, 1) == 0).all()),
                f"{what}: info {int(info)} or strict upper not zero")
        err, lim, rms, yard = trtri_gated(what, W, L)
        print(f"{what} (dense factor, NaN strict upper): max err vs f64 "
              f"{err:.3e}, solve_triangular's {yard:.3e} (limit {lim:.3e}"
              + (f", 1/{rms / lim:.0f} of the strict lower's RMS "
                 f"{rms:.3e})" if rms else ")"))
        if n == 512:
            err_512 = err
    # zero diagonals: info the smallest, read as 1, finite, as the twin
    L = torch.linalg.cholesky(dense_spd(gen, 256)).contiguous()
    L[9, 9] = 0.0
    L[100, 100] = 0.0
    W, info = trtri_block_f32(L)
    want, i_ref = trtri_block_plain(L)
    require(int(info) == 10 == int(i_ref) and bool(torch.isfinite(W).all()),
            f"trtri_block_f32 zero diagonal: info {int(info)}")
    e_z = max_err(W, want)
    require(e_z <= bound(60 * 256, float(want.abs().max())),
            f"trtri_block_f32 zero diagonal: err vs twin {e_z:.3e}")
    # the unit route, and a view with a longer row
    n = 500
    L = torch.linalg.cholesky(dense_spd(gen, n)).contiguous()
    U = unit_form(L)
    W, info = unit_inverse(trtri_block_f32, U)
    require(int(info) == 0 and torch.equal(torch.diagonal(W),
                                           torch.diagonal(U)),
            "trtri_block_f32 unit: info or the diagonal")
    W64 = inverse64(U, unit=True)
    e_u, l_u, _ = gated("trtri_block_f32 unit", torch.tril(W, -1),
                        torch.tril(W64, -1),
                        max_err(torch.tril(unit_inverse(
                            solve_inverse, U)[0], -1),
                            torch.tril(W64, -1)))
    buf = torch.full((n, n + 37), 7.0, device="cuda")
    v = buf[:, 5:5 + n]
    v.copy_(L)
    W, info = trtri_block_f32(v)
    require(int(info) == 0, "trtri_block_f32 view: info")
    e_v, l_v, _, _ = trtri_gated("trtri_block_f32 view", W, L)
    print(f"trtri_block_f32 zero diagonals L[9,9] = L[100,100] = 0 (n=256): "
          f"info 10, finite, err vs twin {e_z:.3e}; unit route n={n}: "
          f"max err vs f64 {e_u:.3e} (limit {l_u:.3e}), diagonal passed "
          f"through; view of leading stride {n + 37}: {e_v:.3e} (limit "
          f"{l_v:.3e})")
    # the times
    for n in (128, 512, 1024):
        L = torch.linalg.cholesky(dense_spd(gen, n)).contiguous()
        ms = bench_op(lambda x: trtri_block_f32(x), L, reps=50) * 1e3
        plain_ms = bench_op(lambda x: trtri_block_plain(x), L, warmup=1,
                            reps=3) * 1e3
        eye = torch.eye(n, device="cuda")
        lib_ms = bench_op(lambda x: torch.linalg.solve_triangular(
            x, eye, upper=False), L, reps=50) * 1e3
        rl = roofline(n ** 3 / 3, "f32", 2 * tri_bytes(n))
        print(f"trtri_block_f32 n={n}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, "
              f"torch.linalg.solve_triangular(L, I) {lib_ms:.4f} ms, bound "
              f"{rl['bound_ms']:.4f} ms ({rl['bound_by']}) on {on}")
        if n == 512:
            rec["trtri_block_f32"] = dict(
                max_abs_err=err_512, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **rl)


@contextlib.contextmanager
def whole_min(tiles: int):
    """The tile count from which lauum_stream_f32 and a trtri_stream_f32
    level take a block a tile (below it equal runs) for a while:
    mega.STREAM_WHOLE_MIN_TILES, their only selector."""
    keep = mega.STREAM_WHOLE_MIN_TILES
    mega.STREAM_WHOLE_MIN_TILES = tiles
    try:
        yield
    finally:
        mega.STREAM_WHOLE_MIN_TILES = keep


#: the A/B's settings of STREAM_WHOLE_MIN_TILES: every level a tile a block,
#: from one wave, two, four, and no level
WHOLE_AB = (1, ksyrk.WAVE, 2 * ksyrk.WAVE, 4 * ksyrk.WAVE, 1 << 30)


def trace_trtri_stream(L, on):
    """One traced trtri_stream_f32 launch on L (after one untraced warm-up):
    per phase kind the µs from block 0's entry to the last block's end,
    summed over the levels, the top level apart, and the gaps to the next
    phase's entry (the grid syncs, or the launches between phases)."""
    n = L.shape[0]
    names = mega.trtri_stream_phases(n)
    trtri_stream_f32(L)
    tr = torch.zeros(len(names), mega.TRTRI_TRACE_SLOTS, dtype=torch.int64,
                     device="cuda")
    torch.cuda.synchronize()
    require(int(trtri_stream_f32(L, trace=tr)[1]) == 0, "traced launch: info")
    t = (tr.cpu() - int(tr[0, 0])).double() / 1e3
    work = [float(t[i, 1] - t[i, 0]) for i in range(len(names))]
    gaps = sum(float(t[i + 1, 0] - t[i, 1]) for i in range(len(names) - 1))
    kinds, top = {}, []
    for name, w in zip(names, work):
        kind = name.split(" ", 2)[2] if name.startswith("level") else name
        kinds[kind] = kinds.get(kind, 0.0) + w
        if name.startswith(f"level {n // 2} "):
            top.append(f"{kind} {w:.1f}")
    print(f"trtri_stream_f32 trace n={n} (levels "
          f"{mega.trtri_stream_plan(n)}): "
          f"total {float(t[-1, 1]):.1f} µs; summed over the levels "
          + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
          + f" (the top level: {', '.join(top)}); gaps between phases "
          f"{gaps:.1f} on {on}")


def solve_inverse(L):
    """tril(L)⁻¹ by one f32 solve_triangular against the identity, zero
    diagonals read as 1: the f32 yardstick of the inverses."""
    zero = torch.diagonal(L) == 0
    T = torch.tril(L, -1) + torch.diag(torch.where(zero, 1.0, L.diagonal()))
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    W = torch.linalg.solve_triangular(T, eye, upper=False)
    info = torch.where(zero.any(), zero.int().argmax() + 1, 0).to(torch.int32)
    return torch.tril(W), info


def check_trtri_stream(gen, rec, on):
    """The whole-matrix inverse (128 leaves, then the levels of
    mega.trtri_levels in balanced runs of the 128 tile) against an f64
    inverse of a dense factor, gated on solve_triangular's f32 error, at
    n = 128, 1024, 1152, 2048, 4096 and 8192 with a NaN strict upper, each
    call repeated bit for bit; zero diagonals at 9, 700 and 1200 (info 10);
    the unit route; views with a longer row, on and off the 16-byte grid;
    the phase trace; the A/B of the tile count from which a level takes a
    block a tile; the times beside solve_triangular(L, I) and trti2_f32 on
    the same factor; and for the routing, trti2_f32 beside it at 1152-4096 and,
    at 8192, the public trtri on the route the tuning table gives it, the
    recursion of a 4096 cap (two launches at 4096 and two gemm_f32
    products) and one launch."""
    Ls = {}
    for n in (128, 1024, 1152, 2048, 4096, 8192):
        F, info = ct.potrf("L", dense_spd(gen, n))
        require(int(info) == 0, f"trtri_stream input factor n={n}")
        L = torch.tril(F)
        del F
        X = L.clone()
        X[torch.ones_like(X, dtype=torch.bool).triu(1)] = math.nan
        rule = mega.STREAM_WHOLE_MIN_TILES
        for tiles in (rule, 1, 1 << 30):
            with whole_min(tiles):
                W, info = trtri_stream_f32(X)
                again, _ = trtri_stream_f32(X)
                what = (f"trtri_stream_f32 n={n} levels (s, whole) "
                        f"{mega.trtri_stream_plan(n)}")
            require(int(info) == 0 and bool((torch.triu(W, 1) == 0).all()),
                    f"{what}: info {int(info)} or strict upper not zero")
            require(torch.equal(W, again), f"{what}: a second call differs")
            err, lim, rms, yard = trtri_gated(what, W, L)
            print(f"{what} (dense factor, NaN strict upper): max err vs f64 "
                  f"{err:.3e}, solve_triangular's {yard:.3e} (limit "
                  f"{lim:.3e}, 1/{rms / lim:.0f} of the strict lower's RMS "
                  f"{rms:.3e}); a second call equal bit for bit")
            if n == 4096 and tiles == rule:
                err_4096 = err
            del W, again
        del X
        if n in (1152, 2048, 4096, 8192):
            Ls[n] = L
    # zero diagonals: info the smallest, read as 1, finite, as the twin
    Z = Ls[2048].clone()
    for z in (9, 700, 1200):
        Z[z, z] = 0.0
    W, info = trtri_stream_f32(Z)
    want, i_ref = trtri_stream_plain(Z)
    require(int(info) == 10 == int(i_ref) and bool(torch.isfinite(W).all()),
            f"trtri_stream_f32 zero diagonals: info {int(info)}")
    e_z = max_err(W, want)
    require(e_z <= bound(60 * 2048, float(want.abs().max())),
            f"trtri_stream_f32 zero diagonals: err vs twin {e_z:.3e}")
    # the unit route, and views with a longer row
    n = 1152
    U = unit_form(Ls[n])
    W, info = unit_inverse(trtri_stream_f32, U)
    require(int(info) == 0 and torch.equal(torch.diagonal(W),
                                           torch.diagonal(U)),
            "trtri_stream_f32 unit: info or the diagonal")
    W64 = inverse64(U, unit=True)
    e_u, l_u, _ = gated("trtri_stream_f32 unit", torch.tril(W, -1),
                        torch.tril(W64, -1),
                        max_err(torch.tril(unit_inverse(solve_inverse, U)[0],
                                           -1), torch.tril(W64, -1)))
    views = []
    for n, off, extra in ((1152, 5, 37), (2048, 128, 128)):
        buf = torch.full((n, n + extra), 7.0, device="cuda")
        v = buf[:, off:off + n]
        v.copy_(Ls[n])
        W, info = trtri_stream_f32(v)
        require(int(info) == 0, "trtri_stream_f32 view: info")
        e_v, l_v, _, _ = trtri_gated("trtri_stream_f32 view", W, Ls[n])
        views.append(f"n={n} leading stride {n + extra} column {off}: "
                     f"{e_v:.3e} (limit {l_v:.3e})")
        del buf, v
    print(f"trtri_stream_f32 zero diagonals at 9, 700, 1200 (n=2048): info "
          f"10, finite, err vs twin {e_z:.3e}; unit route n=1152: max err vs "
          f"f64 {e_u:.3e} (limit {l_u:.3e}), diagonal passed through; views "
          + "; ".join(views))
    # the trace, and the A/B of the cut in turns
    for n in (2048, 4096, 8192):
        reps = 20 if n < 8192 else 5
        trace_trtri_stream(Ls[n], on)
        t = {}
        for tiles in WHOLE_AB + WHOLE_AB[::-1]:
            with whole_min(tiles):
                t.setdefault(tiles, []).append(bench_op(
                    lambda x: trtri_stream_f32(x), Ls[n], reps=reps) * 1e3)
        print(f"trtri_stream_f32 A/B n={n}, a tile a block from this many "
              "tiles of a level, below it runs for one wave: "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in t.items())
              + f" ms (the rule: {mega.STREAM_WHOLE_MIN_TILES}) on {on}")
    # the times, beside solve_triangular and trti2_f32 on the same factor
    for n in (2048, 4096, 8192):
        L = Ls[n]
        reps = 20 if n < 8192 else 5
        t = [bench_op(fn, L, reps=reps) * 1e3
             for fn in (trtri_stream_f32, trti2_f32, trti2_f32,
                        trtri_stream_f32)]
        plain_ms = bench_op(lambda x: trtri_stream_plain(x), L, warmup=1,
                            reps=3) * 1e3
        eye = torch.eye(n, device="cuda")
        lib_ms = bench_op(lambda x: torch.linalg.solve_triangular(
            x, eye, upper=False), L, reps=reps) * 1e3
        rl = roofline(n ** 3 / 3, "f32", 2 * tri_bytes(n))
        print(f"trtri_stream_f32 n={n}: kernel {t[0]:.4f}/{t[3]:.4f} ms, "
              f"trti2_f32 {t[1]:.4f}/{t[2]:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.linalg.solve_triangular(L, I) {lib_ms:.4f} ms, bound "
              f"{rl['bound_ms']:.4f} ms ({rl['bound_by']}) on {on}")
        if n == 4096:
            rec["trtri_stream_f32"] = dict(
                max_abs_err=err_4096, ms=min(t[0], t[3]), plain_ms=plain_ms,
                library_ms=lib_ms, **rl)
        del eye
    # records for the routing: trti2_f32 where _KernelTiles.trti2 takes this
    # kernel, and at 8192 the public trtri (the table's route and a 4096
    # cap's recursion) against one launch
    for n in (1152, 2048, 3072, 4096):
        Lm = Ls[8192][:n, :n].contiguous()
        t = [bench_op(fn, Lm, reps=10) * 1e3
             for fn in (trti2_f32, trtri_stream_f32, trtri_stream_f32,
                        trti2_f32)]
        print(f"routing record n={n}: trti2_f32 {t[0]:.4f}/{t[3]:.4f} ms, "
              f"trtri_stream_f32 {t[1]:.4f}/{t[2]:.4f} ms on {on}")
    L = Ls[8192]
    cap4096 = {"trtri_f32": {"mega_max_n": 4096}}
    for what, params in (("table", {}), ("cap 4096", cap4096)):
        with standing_in(params):
            kernels.reset_launch_counts()
            ct.trtri("L", "N", L)
            counts = kernels.launch_counts()
            whole = blocked._mega_ok(8192, "trtri")
        want = only(trtri_stream_f32=1) if whole else only(
            trtri_stream_f32=2, gemm_f32=2)
        require(counts == want, f"trtri n=8192 ({what}): launches {counts}")

    def recursion(x):
        with standing_in(cap4096):
            return ct.trtri("L", "N", x)

    route = ("one trtri_stream_f32" if blocked._mega_ok(8192, "trtri")
             else "two trtri_stream_f32 at 4096, two gemm_f32 4096³")
    t = [bench_op(fn, L, reps=5) * 1e3
         for fn in (lambda x: ct.trtri("L", "N", x), recursion,
                    trtri_stream_f32, trtri_stream_f32, recursion,
                    lambda x: ct.trtri("L", "N", x))]
    print(f"routing record n=8192: the public trtri under the table "
          f"({route}) {t[0]:.4f}/{t[5]:.4f} ms, under a 4096 cap (two "
          f"trtri_stream_f32 at 4096, two gemm_f32 4096³) "
          f"{t[1]:.4f}/{t[4]:.4f} ms, one trtri_stream_f32 "
          f"{t[2]:.4f}/{t[3]:.4f} ms on {on}")


def lauum_plan_on(**plan):
    """lauum_stream_f32's plan with launch_plan's overrides (whole tiles,
    a number of blocks): lauum_launch_plan, its only selector, wrapped for
    a while. Returns the plan to put back."""
    keep = mega.lauum_launch_plan
    mega.lauum_launch_plan = functools.partial(keep, **plan)
    return keep


def check_lauum_stream(gen, rec, on):
    """tril(LᵀL) (the lower tiles' k-steps in equal runs of the 128 tile)
    against f64 on dense factors, gated on the f32 matmul's error, at n =
    128, 1024, 1152, 2048, 4096 and 8192 under the launch plan, with a tile
    a block and in runs for one wave, with a NaN strict upper, each call
    repeated bit for bit; views with a longer row, on and off the 16-byte
    grid; the A/B of equal runs against whole tiles at 1024, 2048, 4096
    and 8192; the times beside torch.matmul(Lᵀ, L)."""
    Ls = {}
    for n in (128, 1024, 1152, 2048, 4096, 8192):
        F, info = ct.potrf("L", dense_spd(gen, n))
        require(int(info) == 0, f"lauum_stream input factor n={n}")
        L = torch.tril(F)
        del F
        ref = torch.tril(L.double().T @ L.double())
        yard = max_err(lauum_stream_plain(L), ref)
        X = L.clone()
        X[torch.ones_like(X, dtype=torch.bool).triu(1)] = math.nan
        for plan in ({}, dict(whole=True), dict(blocks=ksyrk.WAVE)):
            keep = lauum_plan_on(**plan)
            try:
                took = mega.lauum_launch_plan(n)
                B = lauum_stream_f32(X)
                again = lauum_stream_f32(X)
            finally:
                mega.lauum_launch_plan = keep
            what = f"lauum_stream_f32 n={n} plan (q, blocks) {took}"
            require(bool(torch.isfinite(B).all()),
                    f"{what}: read the NaN strict upper")
            require(bool((torch.triu(B, 1) == 0).all()),
                    f"{what}: strict upper not zero")
            require(torch.equal(B, again), f"{what}: a second call differs")
            err, lim, rms = gated(what, B, ref, yard)
            print(f"{what} (dense factor, NaN strict upper): max err vs f64 "
                  f"{err:.3e}, matmul's {yard:.3e} (limit {lim:.3e}, "
                  f"1/{rms / lim:.0f} of the strict lower's RMS {rms:.3e}); "
                  "a second call equal bit for bit")
            if n == 8192 and not plan:
                err_8192 = err
            del B, again
        del X, ref
        if n in (1024, 1152, 2048, 4096, 8192):
            Ls[n] = L
    for n, off, extra in ((1152, 5, 37), (2048, 128, 128)):
        buf = torch.full((n, n + extra), math.nan, device="cuda")
        v = buf[:, off:off + n]
        v.copy_(torch.tril(Ls[n]) + torch.triu(v, 1))
        B = lauum_stream_f32(v)
        ref = torch.tril(Ls[n].double().T @ Ls[n].double())
        err, lim, _ = gated(f"lauum_stream_f32 view n={n}", B, ref,
                            max_err(lauum_stream_plain(Ls[n]), ref))
        print(f"lauum_stream_f32 view n={n} of leading stride {n + extra} "
              f"at column {off}, NaN around the lower triangle: max err vs "
              f"f64 {err:.3e} (limit {lim:.3e})")
        del buf, v, B, ref
    # the A/B of the cut, in turns
    ab = (dict(blocks=ksyrk.WAVE), dict(whole=True))
    for n in (1024, 2048, 4096, 8192):
        reps = 20 if n < 8192 else 5
        t = {}
        for plan in ab + ab[::-1]:
            keep = lauum_plan_on(**plan)
            try:
                t.setdefault(plan_name(plan), []).append(
                    bench_op(lambda x: lauum_stream_f32(x), Ls[n],
                             reps=reps) * 1e3)
            finally:
                mega.lauum_launch_plan = keep
        print(f"lauum_stream_f32 A/B n={n}: equal runs for one wave ("
              + ", ".join(f"{p} {v[0]:.4f}/{v[1]:.4f}" for p, v in t.items())
              + f" ms); the rule takes (q, blocks) "
              f"{mega.lauum_launch_plan(n)} on {on}")
    for n in (2048, 4096, 8192):
        L = Ls[n]
        reps = 20 if n < 8192 else 5
        ms = bench_op(lambda x: lauum_stream_f32(x), L, reps=reps) * 1e3
        plain_ms = bench_op(lambda x: lauum_stream_plain(x), L,
                            reps=reps) * 1e3
        # the library call computes the whole square, six times the work
        lib_ms = bench_op(lambda x: torch.matmul(x.T, x), L, reps=reps) * 1e3
        rl = roofline(n ** 3 / 3, "f32", 2 * tri_bytes(n))
        print(f"lauum_stream_f32 n={n}: kernel {ms:.4f} ms "
              f"({n ** 3 / 3 / ms / 1e9:.1f} TF/s), plain {plain_ms:.4f} ms, "
              f"torch.matmul(Lᵀ, L) {lib_ms:.4f} ms, bound "
              f"{rl['bound_ms']:.4f} ms on {on}")
        if n == 8192:
            rec["lauum_stream_f32"] = dict(
                max_abs_err=err_8192, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **rl)


#: lauu2_f32's sizes: one row, ragged single tiles, a tile and the ragged
#: sizes around it, the recursion's leaves (368, 512) and a ragged and a
#: whole multi-tile block
LAUU2_SIZES = (1, 7, 127, 128, 129, 368, 512, 1000, 2048)
#: the plans of lauu2_f32's A/B: the rule (leaf.lauu2_launch_plan), runs
#: for one wave and for one block an SM, and a tile a block (no sum
#: launch)
LAUU2_PLANS = ({}, dict(blocks=ksyrk.WAVE), dict(blocks=ksyrk.WAVE // 2),
               dict(whole=True))


def lauu2_plan_on(**plan):
    """lauu2_f32's plan forced to mega.lauum_launch_plan with these
    overrides (none: the rule), through leaf.lauu2_launch_plan, its only
    selector, for a while. Returns the plan to put back."""
    keep = leaf.lauu2_launch_plan
    if plan:
        leaf.lauu2_launch_plan = functools.partial(mega.lauum_launch_plan,
                                                   **plan)
    return keep


def nan_upper(n, seed):
    """An n x n int32 pattern of NaNs of many payloads, both signs, quiet
    and signalling, as f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bits = torch.randint(1, 1 << 22, (n, n), device="cuda", generator=g,
                         dtype=torch.int32)
    bits = bits | (0x7F800000 | (bits & 1) << 22)   # exponent all ones
    sign = torch.randint(0, 2, (n, n), device="cuda", generator=g,
                         dtype=torch.int32).bool()
    return torch.where(sign, bits | (-(1 << 31)), bits).view(torch.float32)


def lauu2_leaf(L, layout):
    """L (lower) with a NaN strict upper of many payloads, laid out as the
    leaf a caller passes: a contiguous block, or a view of a wider buffer
    on the 16-byte grid (row stride a multiple of 4) or off it (5 floats
    in, an odd row stride), NaN around the view."""
    n = L.shape[0]
    up = torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1)
    if layout == "contiguous":
        X = torch.empty_like(L)
    else:
        off, width = (4, -(-(n + 8) // 4) * 4) if layout == "on grid" \
            else (5, (n + 8) | 1)
        X = torch.full((n, width), math.nan, device="cuda")[:, off:off + n]
    X.copy_(torch.where(up, nan_upper(n, n), L))
    return X


def lauu2_device_ms(X, calls=20):
    """Device ms of one lauu2_f32 call: the union of its kernels' intervals
    under torch.profiler over ``calls`` calls, over the calls; NaN (not
    measured) when the profiler lost kernels of the window at every
    attempt."""
    lauu2_f32(X)

    def run():
        for _ in range(calls):
            lauu2_f32(X)

    try:
        return profiling.device_time(run, "lau")["busy"][0] / calls
    except profiling.LostKernels:
        return math.nan


def host_ms(fn, X, reps=20):
    """Median host ms to enqueue one fn(X), the card idle before each."""
    fn(X)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(X)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def check_lauu2(gen, rec, on):
    """The leaf lauum (lauum_stream_f32's kernel at any n) on dense
    factors against f64, gated on the f32 matmul's error, at each of
    LAUU2_SIZES under each of LAUU2_PLANS, for a contiguous leaf and views
    on and off the 16-byte grid, each with a NaN strict upper of many
    payloads that must come back bit for bit (as int32), each call
    repeated bit for bit and counted once; the A/B of the plans in turns
    (call and device ms); host, call and device ms beside torch.matmul(Lᵀ,
    L); at 2048 lauum_stream_f32 on the same L; then the lauum and potri
    paths that reach it."""
    Ls = {}
    for n in LAUU2_SIZES:
        F, info = ct.potrf("L", dense_spd(gen, n))
        require(int(info) == 0, f"lauu2 input factor n={n}")
        L = Ls[n] = torch.tril(F)
        ref = torch.tril(L.double().T @ L.double())
        yard = max_err(torch.tril(lauu2_plain(L)), ref)
        # one element has no strict lower: its RMS is the element's
        rms = strict_rms(ref) if n > 1 else float(ref.abs().max())
        up = torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1)
        for layout in ("contiguous", "on grid", "off grid"):
            X = lauu2_leaf(L, layout)
            for plan in LAUU2_PLANS:
                keep = lauu2_plan_on(**plan)
                try:
                    took = leaf.lauu2_launch_plan(n)
                    before = lauu2_f32.launches
                    B = lauu2_f32(X)
                    again = lauu2_f32(X)
                    counted = lauu2_f32.launches - before
                finally:
                    leaf.lauu2_launch_plan = keep
                what = f"lauu2_f32 n={n} {layout} plan (q, blocks) {took}"
                require(B.is_contiguous() and B.shape == (n, n),
                        f"{what}: not a contiguous n x n result")
                require(counted == 2, f"{what}: {counted} launches counted "
                        "for two calls")
                require(torch.equal(B.view(torch.int32)[up],
                                    X.view(torch.int32)[up]),
                        f"{what}: strict upper not passed through bit for "
                        "bit")
                require(torch.equal(B.view(torch.int32),
                                    again.view(torch.int32)),
                        f"{what}: a second call differs")
                err, lim, _ = gated(what, torch.tril(B), ref, yard, rms=rms)
                if n == 2048 and layout == "contiguous" and not plan:
                    err_2048 = err
            print(f"lauu2_f32 n={n} {layout} (dense factor, NaN strict upper "
                  f"of many payloads), plans {len(LAUU2_PLANS)}: max err vs "
                  f"f64 {err:.3e}, matmul's {yard:.3e} (limit {lim:.3e}, "
                  f"1/{rms / lim:.0f} of the reference's RMS {rms:.3e}); "
                  "strict upper bit for bit, a second call equal bit for "
                  "bit, one launch counted a call")
            del X, B, again
        del ref
    # the A/B of the plans, in turns: call and device ms
    ab = LAUU2_PLANS
    for n in (768, 1536):
        Ls[n] = torch.tril(ct.potrf("L", dense_spd(gen, n))[0])
    for n in (128, 368, 512, 768, 1000, 1536, 2048):
        t, dev = {}, {}
        for plan in ab + ab[::-1]:
            keep = lauu2_plan_on(**plan)
            try:
                name = plan_name(plan) or "rule"
                t.setdefault(name, []).append(
                    bench_op(lambda x: lauu2_f32(x), Ls[n], reps=20) * 1e3)
                dev.setdefault(name, []).append(lauu2_device_ms(Ls[n]))
            finally:
                leaf.lauu2_launch_plan = keep
        print(f"lauu2_f32 A/B n={n}: call / device ms "
              + ", ".join(f"{p} {v[0]:.4f}/{v[1]:.4f} / "
                          f"{dev[p][0]:.4f}/{dev[p][1]:.4f}"
                          for p, v in t.items())
              + f"; the rule takes (q, blocks) {leaf.lauu2_launch_plan(n)} "
              f"on {on}")
    for n in (128, 368, 512, 1000, 2048):
        L = Ls[n]
        ms = bench_op(lambda x: lauu2_f32(x), L, reps=20) * 1e3
        dev_ms = lauu2_device_ms(L)
        enq = host_ms(lauu2_f32, L)
        plain_ms = bench_op(lambda x: lauu2_plain(x), L, reps=20) * 1e3
        lib_ms = bench_op(lambda x: torch.matmul(x.T, x), L, reps=20) * 1e3
        # the strict upper passes through: the whole block in and out
        rl = roofline(n ** 3 / 3, "f32", 2 * n * n * 4)
        stream = ""
        if n == 2048:
            st = [bench_op(fn, L, reps=20) * 1e3 for fn in (
                lauu2_f32, lauum_stream_f32, lauum_stream_f32, lauu2_f32)]
            stream = (f"; in turns with lauum_stream_f32 on the same L: "
                      f"lauu2_f32 {st[0]:.4f}/{st[3]:.4f}, lauum_stream_f32 "
                      f"{st[1]:.4f}/{st[2]:.4f} ms")
        print(f"lauu2_f32 n={n}: kernel {ms:.4f} ms (device {dev_ms:.4f}, "
              f"host enqueue {enq:.4f}), plain {plain_ms:.4f} ms, "
              f"torch.matmul(Lᵀ, L) {lib_ms:.4f} ms, bound "
              f"{rl['bound_ms']:.4f} ms ({rl['bound_by']}){stream} on {on}")
        if n == 2048:
            rec["lauu2_f32"] = dict(
                max_abs_err=err_2048, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **rl)
    # lauum with 2048 leaves at 4096: two lauu2_f32 launches, above the
    # 1024 the kernel took before
    F, info = ct.potrf("L", spd(gen, 4096))
    L = torch.tril(F)
    B, _ = run_path("lauum block_size=2048",
                    lambda: ct.lauum("L", L, block_size=2048),
                    {"lauu2_f32": 2})
    e4 = max_err(torch.tril(B), lauum_stream_plain(L))
    b4 = bound(2 * 4096 + 3, float(B.abs().max()))
    require(e4 <= b4, f"lauum block_size=2048 n=4096: err {e4} > {b4}")
    print(f"lauum n=4096 block_size=2048 (two lauu2_f32 leaves): max err "
          f"{e4:.3e} against the twin (bound {b4:.3e})")
    # potri at 6000: the working copy is padded to 6144, a multiple of
    # 128, which the whole-matrix kernels take (one trtri_stream_f32, or
    # two at 3072 and two gemm_f32 under a trtri_f32 cap below 6144, and
    # one lauum_stream_f32): no leaf
    F6 = torch.tril(ct.potrf("L", dense_spd(gen, 6000, 30.0))[0])
    (inv6, info6), _ = run_path("potri n=6000", lambda: ct.potri("L", F6),
                                {"lauu2_f32": 0})
    require(int(info6) == 0, "potri n=6000 info")
    low = torch.ones(6000, 6000, dtype=torch.bool, device="cuda").tril_()
    inv64 = torch.cholesky_inverse(F6.double())
    d = torch.where(low, inv6.double() - inv64, 0.0)
    r6 = float(d.norm() / torch.where(low, inv64, 0.0).norm())
    require(r6 <= 1e-4, f"potri n=6000: relative error {r6} > 1e-4")
    print(f"potri n=6000: relative Frobenius error {r6:.3e} vs f64 "
          "cholesky_inverse (limit 1e-4)")
    del F6, inv6, inv64, d, low


def check_potf2(gen, rec, on):
    """The leaf Cholesky (strips of leaf.POTF2_KB columns) against an f64
    factor of a dense SPD input, gated on its twin's error (the same walk in
    torch), at n = 100 to the path's 16384 with a NaN strict upper; failed
    pivots in the first, a middle and the last strip and a NaN pivot; a
    view off the 16-byte grid; the A/B of the strip width at 16384; the
    times at 4096, 8192 and 16384 beside cholesky_ex."""
    for n in (100, 128, 256, 1024, 2048, 4096, 16384):
        A = dense_spd(gen, n)
        F = A.clone()
        F[torch.ones_like(F, dtype=torch.bool).triu(1)] = float("nan")
        info = potf2_f32(F)
        want = A.clone()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        i_ref = potf2_plain(want)
        t1.record()
        t1.synchronize()
        require(int(info) == 0 and int(i_ref) == 0,
                f"potf2_f32 n={n}: info {int(info)}/{int(i_ref)}")
        require(bool(torch.isfinite(F).all())
                and bool((torch.triu(F, 1) == 0).all()),
                f"potf2_f32 n={n}: read the NaN strict upper or left it")
        L64 = torch.linalg.cholesky(A.double())
        err, lim, rms = gated(f"potf2_f32 n={n}", F, L64, max_err(want, L64))
        print(f"potf2_f32 n={n} (dense, cond 100): max err vs f64 "
              f"{err:.3e}, the twin's {max_err(want, L64):.3e} (limit "
              f"{lim:.3e}, 1/{rms / lim:.0f} of the strict lower's RMS "
              f"{rms:.3e}), NaN strict upper unread")
        del F, want, L64
    plain_ms = t0.elapsed_time(t1)
    # the strip width's A/B at 16384, in turns
    t = {}
    for kb in (256, 512, 1024, 1024, 512, 256):
        keep = leaf.POTF2_KB
        leaf.POTF2_KB = kb
        try:
            t.setdefault(kb, []).append(ms_inplace(potf2_f32, A, reps=1))
        finally:
            leaf.POTF2_KB = keep
    print(f"potf2_f32 n={n} strip width A/B: "
          + ", ".join(f"{kb} {v[0]:.3f}/{v[1]:.3f} ms"
                      for kb, v in sorted(t.items()))
          + f" (the default {leaf.POTF2_KB}) on {on}")
    for m in (4096, 8192, n):
        B = A if m == n else dense_spd(gen, m)
        ms = ms_inplace(potf2_f32, B, reps=3)
        lib_ms = ms_inplace(torch.linalg.cholesky_ex, B, reps=3)
        rl = roofline(m ** 3 / 3, "f32", 2 * tri_bytes(m))
        print(f"potf2_f32 n={m}: kernel {ms:.4f} ms (copies made before the "
              f"clock), torch.linalg.cholesky_ex {lib_ms:.4f} ms, bound "
              f"{rl['bound_ms']:.4f} ms ({rl['bound_by']})"
              + (f", plain {plain_ms:.4f} ms (one run)" if m == n else "")
              + f" on {on}")
        del B
    rec["potf2_f32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, **rl)
    del A
    # failed pivots in the first, a middle and the last strip of 512 and a
    # NaN pivot: info, frozen and finite but an input NaN pivot, the
    # leading block against its f64 factor, gated on the twin's
    for n, k, v in ((2048, 5, -1.0), (2048, 1000, -1.0), (2048, 2040, -1.0),
                    (2048, 1100, float("nan")), (256, 7, float("nan"))):
        A = dense_spd(gen, n, 10.0)
        A[k, k] = v
        L64 = torch.linalg.cholesky(A[:k, :k].double())
        want = A.clone()
        i_ref = potf2_plain(want)
        info = potf2_f32(A)
        bad = (~torch.isfinite(A)).nonzero().tolist()
        require(int(info) == k + 1 == int(i_ref)
                and all(ix == [k, k] for ix in bad),
                f"potf2_f32 A[{k},{k}]={v}: info {int(info)}, non-finite at "
                f"{bad[:5]}")
        gated(f"potf2_f32 A[{k},{k}]={v}: leading block", A[:k, :k], L64,
              max_err(want[:k, :k], L64))
    # a view one column into a buffer of odd row length: nothing outside
    # the view written
    n = 2048
    A = dense_spd(gen, n)
    want = A.clone()
    potf2_plain(want)
    buf = torch.full((n, n + 3), 7.0, device="cuda")
    v = buf[:, 1:1 + n]
    v.copy_(A)
    require(int(potf2_f32(v)) == 0, "potf2_f32 view: info")
    L64 = torch.linalg.cholesky(A.double())
    e_v, l_v, _ = gated(f"potf2_f32 n={n} view", v, L64, max_err(want, L64))
    require(bool((buf[:, 0] == 7.0).all() and (buf[:, 1 + n:] == 7.0).all()),
            "potf2_f32 wrote outside the view")
    print("potf2_f32 failed pivots A[5,5], A[1000,1000], A[2040,2040]=-1 "
          "(n=2048: the first, a middle and the last strip) and NaN pivots "
          "A[1100,1100] (n=2048) and A[7,7] (n=256): info k+1, nothing but "
          "an input NaN pivot non-finite, each leading block within the "
          f"gate; a view off the 16-byte grid (leading stride {n + 3}): max "
          f"err vs f64 {e_v:.3e} (limit {l_v:.3e}), nothing outside it "
          "written")


def unit_form(L):
    """L with each column scaled to a unit diagonal, L's own diagonal
    stored on it (for a unit-diagonal inverse to pass through)."""
    d = torch.diagonal(L)
    return L / d[None, :] + torch.diag(d - 1.0)


def inverse64(L, unit=False):
    """The f64 inverse of tril(L) (unit diagonal with ``unit``, L's own
    diagonal then put back, as trti2 passes it through)."""
    n = L.shape[0]
    W = torch.linalg.solve_triangular(
        torch.tril(L).double(),
        torch.eye(n, dtype=torch.float64, device=L.device), upper=False,
        unitriangular=unit)
    if unit:
        W.diagonal().copy_(torch.diagonal(L))
    return W


def check_trti2(gen, rec, on):
    """The leaf inverse (leaves, then the levels of mega.trtri_levels)
    against an f64 inverse of a dense factor, gated on its twin's error
    (the same order of work in torch), non-unit and unit, with a NaN strict
    upper, at n = 100 (one short leaf), 384 and 1280 (an unpaired block at
    a level, a short last pair), 1024, 8320 (the strtri path's block, past
    the whole-matrix kernels' cap) and 8192; zero diagonals (info the
    smallest, past the first 1024 at 8192; with unit, info 0 and the zero
    passed through); the times at 1024 and 8192 beside solve_triangular(L,
    I), and beside trtri_stream_f32 at 2048, 4096 and 8192."""
    for n in (100, 384, 1280, 1024, TRTI2_N, 8192):
        F, info = ct.potrf("L", dense_spd(gen, n))
        require(int(info) == 0, f"trti2 input factor n={n}")
        L = torch.tril(F)
        del F
        for unit in (False, True):
            Lu = unit_form(L) if unit else L
            X = Lu.clone()
            X[torch.ones_like(X, dtype=torch.bool).triu(1)] = float("nan")
            W, info = trti2_f32(X, unit=unit)
            want, i_ref = trti2_plain(Lu, unit)
            what = f"trti2_f32 n={n} unit={unit}"
            require(int(info) == 0 == int(i_ref), f"{what}: info {int(info)}")
            require(bool((torch.triu(W, 1) == 0).all()),
                    f"{what}: strict upper not zero")
            if unit:
                require(torch.equal(torch.diagonal(W), torch.diagonal(Lu)),
                        f"{what}: the diagonal was not passed through")
            W64 = inverse64(Lu, unit)
            err, lim, rms = gated(what, W, W64, max_err(want, W64))
            print(f"{what} (dense factor): max err vs f64 {err:.3e}, the "
                  f"twin's {max_err(want, W64):.3e} (limit {lim:.3e}, "
                  f"1/{rms / lim:.0f} of the strict lower's RMS {rms:.3e}), "
                  "NaN strict upper unread")
            if n == 8192 and not unit:
                err8 = err
            del W, want, W64, X
        Z = L.clone()
        zeros = (9, 700, 1200) if n == 1280 else (5000, 7000) if n == 8192 \
            else ()
        for z in zeros:
            Z[z, z] = 0.0
        if zeros:
            W, info = trti2_f32(Z)
            first = int(info)
            require(first == zeros[0] + 1 and bool(torch.isfinite(W).all()),
                    f"trti2_f32 zero diagonals {zeros}: info {first}")
            if n == 1280:
                want, i_ref = trti2_plain(Z)
                e_z = max_err(W, want)
                require(int(i_ref) == 10
                        and e_z <= bound(60 * n, float(want.abs().max())),
                        f"trti2_f32 zero diagonals: err vs twin {e_z:.3e}")
                W, info = trti2_f32(unit_form(L).index_put_(
                    (torch.tensor(zeros, device="cuda"),) * 2,
                    torch.zeros(3, device="cuda")), unit=True)
                require(int(info) == 0 and all(float(W[z, z]) == 0.0
                                               for z in zeros),
                        "trti2_f32 unit with zero diagonals: info "
                        f"{int(info)} or the zeros not passed through")
            print(f"trti2_f32 n={n} zero diagonals at {zeros}: info "
                  f"{first}, finite"
                  + (f", err vs twin {e_z:.3e}; unit: info 0, the zeros "
                     "passed through" if n == 1280 else ""))
            del W, Z
        if n == 1024:
            L1024 = L
    eye = torch.eye(n, device="cuda")
    for m, Lm in ((1024, L1024), (n, L)):
        ms = bench_op(lambda x: trti2_f32(x), Lm, reps=5) * 1e3
        plain_ms = bench_op(lambda x: trti2_plain(x), Lm, reps=3) * 1e3
        lib_ms = bench_op(lambda x: torch.linalg.solve_triangular(
            x, eye[:m, :m], upper=False), Lm, reps=5) * 1e3
        rl = roofline(m ** 3 / 3, "f32", 2 * tri_bytes(m))
        print(f"trti2_f32 n={m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, torch.linalg.solve_triangular(L, I) {lib_ms:.4f} ms, "
              f"bound {rl['bound_ms']:.4f} ms ({rl['bound_by']}) on {on}")
    rec["trti2_f32"] = dict(max_abs_err=err8, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, **rl)
    # beside trtri_stream_f32, which _KernelTiles.trti2 takes up to its cap
    for m in (2048, 4096, 8192):
        Lm = L[:m, :m].contiguous()
        t = [bench_op(fn, Lm, reps=5) * 1e3
             for fn in (trti2_f32, trtri_stream_f32, trtri_stream_f32,
                        trti2_f32)]
        print(f"trti2_f32 / trtri_stream_f32 n={m}: {t[0]:.4f}/{t[3]:.4f} "
              f"against {t[1]:.4f}/{t[2]:.4f} ms on {on}")


def rms_of(R) -> float:
    return float(R.double().square().mean().sqrt())


def check_trmm(gen, rec, on):
    """The live-block trmm against an f64 product, gated on its twin's
    error (f32 tril(L)·B), at a ragged shape and the path's 8192², then
    the upper unit form (the reversed views) at 8192²."""
    for n, m in ((200, 130), (8192, 8192)):
        # the whole square is given: only the lower triangle may be read
        L = torch.randn(n, n, device="cuda", generator=gen)
        B = torch.randn(n, m, device="cuda", generator=gen)
        want = trmm_lln_plain(L, B, 1.5)
        ref = 1.5 * (torch.tril(L).double() @ B.double())
        L[torch.ones_like(L, dtype=torch.bool).triu(1)] = float("nan")
        got = trmm_lln_f32(L, B, alpha=1.5)
        err, lim, rms = gated(f"trmm_lln_f32 {n}x{m}", got, ref,
                              max_err(want, ref), rms=rms_of(ref))
        print(f"trmm_lln_f32 L {n}², B {n}x{m}: max err vs f64 {err:.3e}, "
              f"the twin's {max_err(want, ref):.3e} (limit {lim:.3e}), NaN "
              f"strict upper unread")
        del want, ref, got
    # T = triu(U) with a unit diagonal: pointers to the last rows and
    # negated strides; the strict lower and the diagonal hold NaN
    U = torch.randn(n, n, device="cuda", generator=gen)
    want = trmm_lln_plain(U, B, 1.5, upper=True, unit=True)
    T64 = torch.triu(U.double())
    T64.diagonal().fill_(1.0)
    ref = 1.5 * (T64 @ B.double())
    del T64
    U[torch.ones_like(U, dtype=torch.bool).tril()] = float("nan")
    got = trmm_lln_f32(U, B, alpha=1.5, upper=True, unit=True)
    e_up, lim, rms = gated(f"trmm_lln_f32 upper unit {n}x{m}", got, ref,
                           max_err(want, ref), rms=rms_of(ref))
    print(f"trmm_lln_f32 upper=True unit=True {n}x{m}: max err vs f64 "
          f"{e_up:.3e}, the twin's {max_err(want, ref):.3e} (limit "
          f"{lim:.3e}), NaN strict lower and diagonal unread")
    del U, want, ref, got
    L = torch.tril(L)
    ms = bench_op(lambda x: trmm_lln_f32(L, x), B, reps=5) * 1e3
    plain_ms = bench_op(lambda x: trmm_lln_plain(L, x), B, reps=5) * 1e3
    lib_ms = bench_op(lambda x: torch.matmul(L, x), B, reps=5) * 1e3
    print(f"trmm_lln_f32 n=m={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.matmul(tril(L), B) {lib_ms:.4f} ms on {on}")
    rec["trmm_lln_f32"] = dict(
        max_abs_err=max(err, e_up), ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms,
        **roofline(n * (n + 1) * m, "f32", tri_bytes(n) + 2 * n * m * 4))


D_SLICES = 6       # the d tier's slices per operand (_OzakiTiles)


def check_peel(gen, rec, on):
    """The peels of the d path: the hoisted peel of a whole 8192 triangle,
    and a 128-wide column panel of the working buffer (a strided view),
    bit for bit against the twin; peel_f64, the path's one launch a peel,
    also on the triangle's transpose (a column-major view), slices and
    row scales bit for bit against its twin (scaled_pair, then the
    peel)."""
    buf = torch.randn(8192, 8192, dtype=torch.float64, device="cuda",
                      generator=gen)
    L = torch.tril(buf)
    err = 0.0
    for what, X in (("8192² triangle", L), ("8192×128 column view",
                                             buf[:, 256:384])):
        rh, rl, _ = scaled_pair(X)
        got = peel_f32pair(rh, rl, slices=D_SLICES)
        want = peel_plain(rh, rl, D_SLICES)
        require(torch.equal(got, want),
                f"peel_f32pair {what}: not bit for bit the twin's "
                f"(max diff {max_err(got, want)})")
        err = max(err, max_err(got, want))
        print(f"peel_f32pair {what}, S={D_SLICES}: bit for bit the twin's")
    rh, rl, _ = scaled_pair(L)
    ms = bench_op(lambda x: peel_f32pair(x, rl, slices=D_SLICES), rh) * 1e3
    plain_ms = bench_op(lambda x: peel_plain(x, rl, D_SLICES), rh,
                        reps=3) * 1e3
    print(f"peel_f32pair 8192², S={D_SLICES}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms on {on}")
    # 8 bytes in and S out per element; no library call peels
    rec["peel_f32pair"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **roofline(10 * D_SLICES * 8192 ** 2, "f32",
                   (8 + D_SLICES) * 8192 ** 2))
    err = 0.0
    for what, X in (("8192² triangle", L), ("8192×128 column view",
                                             buf[:, 256:384]),
                    ("8192² triangle transposed", L.T)):
        got, gsc = peel_f64(X, slices=D_SLICES)
        want, wsc = peel_f64_plain(X, D_SLICES)
        require(torch.equal(got, want) and torch.equal(gsc, wsc),
                f"peel_f64 {what}: not bit for bit the twin's (max diff "
                f"{max_err(got, want)}, scales {max_err(gsc, wsc)})")
        err = max(err, max_err(got, want))
        print(f"peel_f64 {what}, S={D_SLICES}: bit for bit the twin's")
    ms = bench_op(lambda x: peel_f64(x, slices=D_SLICES), L) * 1e3
    ms_t = bench_op(lambda x: peel_f64(x, slices=D_SLICES), L.T) * 1e3
    plain_ms = bench_op(lambda x: peel_f64_plain(x, D_SLICES), L,
                        reps=3) * 1e3
    rl = roofline(10 * D_SLICES * 8192 ** 2, "f32",
                  (8 + D_SLICES) * 8192 ** 2 + 8 * 8192)
    print(f"peel_f64 8192², S={D_SLICES}: kernel {ms:.4f} ms (transposed "
          f"view {ms_t:.4f} ms), plain {plain_ms:.4f} ms, byte bound "
          f"{rl['bound_ms']:.4f} ms on {on}")
    # 8 bytes in and S out per element, a row scale out per row
    rec["peel_f64"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=None, **rl)


def check_mm_groups(gen, rec, on):
    """The grouped slice products of the d path against the twin, within
    1e-12·max|ref| (the JAX package's bound of its fused kernel against
    the plain products): an 8192×128 row panel times a 128-wide leaf (the
    panel solve's leaf product), dpotrf's top trailing update at 8192 (a
    4096² panel times itself, one peel for both sides), sub-block views of
    one hoisted peel of the factor, one of them at a k offset that is not
    a multiple of 16, and S = 1, 4, 8 on ragged shapes."""
    buf = torch.randn(8192, 8192, dtype=torch.float64, device="cuda",
                      generator=gen)
    T = torch.tril(torch.randn(128, 128, dtype=torch.float64, device="cuda",
                               generator=gen))
    Ps, _ = ozaki.split_rows(buf[:, 256:384], D_SLICES)
    Ts, _ = ozaki.split_rows(T, D_SLICES)             # the peel of (Tᵀ)ᵀ
    Xs, _ = ozaki.split_rows(buf[4096:, :4096], D_SLICES)
    Ls, _ = ozaki.split_rows(torch.tril(buf[:4096, :4096]), D_SLICES)
    Ws, _ = ozaki.split_rows(buf[:4096, 4096:6144], D_SLICES)
    Us, _ = ozaki.split_rows(buf[:500, 6000:7000], D_SLICES)
    cases = {"8192×128·128": (Ps, Ts), "4096³ (syrk, one peel)": (Xs, Xs),
             "4096×2048·2048 on a view of a hoisted peel":
                 (Ws, Ls[:, 2048:4096, :2048]),
             # k offset 40: the wrapper copies the rows to 16-byte starts
             "500×2000·1000 on a view at k offset 40 of a hoisted peel":
                 (Us, Ls[:, 1000:3000, 40:1040])}
    # other slice counts (matmul_f64 defaults to 4), ragged m, n and k;
    # 2000×600 takes the 64 × 128 tiles, the others the 64 × 64 ones
    for S, (m, n, k) in ((1, (300, 200, 100)), (4, (2000, 600, 700)),
                         (8, (777, 130, 1001))):
        X = torch.randn(m + n, k, dtype=torch.float64, device="cuda",
                        generator=gen)
        Ss, _ = ozaki.split_rows(X, S)
        cases[f"{m}×{n}·{k}, S={S}"] = (Ss[:, :m], Ss[:, m:])
    errs = {}
    for what, (As, Bs) in cases.items():
        hi, lo = mm_groups_f32pair(As, Bs)
        rh, rl = mm_groups_plain(As, Bs)
        ref = rh.double() + rl.double()
        err = max_err(hi.double() + lo.double(), ref)
        b = 1e-12 * float(ref.abs().max())
        require(err <= b, f"mm_groups_f32pair {what}: err {err} > {b}")
        errs[what] = err
        print(f"mm_groups_f32pair {what}, S={As.shape[0]}: max err "
              f"{err:.3e} (bound {b:.3e})")
    ms_p = bench_op(lambda a: mm_groups_f32pair(a, Ts), Ps) * 1e3
    P64, T64 = buf[:, 256:384], T
    lib_p = bench_op(lambda a: torch.matmul(a, T64.T), P64) * 1e3
    print(f"mm_groups_f32pair 8192×128·128: kernel {ms_p:.4f} ms, f64 "
          f"torch.matmul {lib_p:.4f} ms on {on}")
    ms = bench_op(lambda a: mm_groups_f32pair(a, a), Xs, reps=5) * 1e3
    plain_ms = bench_op(lambda a: mm_groups_plain(a, a), Xs, reps=3) * 1e3
    X64 = buf[4096:, :4096]
    lib_ms = bench_op(lambda a: torch.matmul(a, a.T), X64, reps=5) * 1e3
    # S(S+1)/2 int8 products; one peel (S bytes per element) read, an f32
    # pair written
    rl = groups_roofline(4096, 4096, 4096, one_peel=True)
    print(f"mm_groups_f32pair 4096³: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, f64 torch.matmul {lib_ms:.4f} ms, int8 bound "
          f"{rl['bound_ms']:.4f} ms on {on}")
    rec["mm_groups_f32pair"] = dict(
        max_abs_err=errs["4096³ (syrk, one peel)"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, **rl)
    check_mm_groups_f64(gen, rec, on, Xs)


def check_mm_groups_f64(gen, rec, on, Xs):
    """mm_groups_f64, the path's one launch a product: bit for bit the
    twin's epilogue of mm_groups_f32pair's pair (the merge, the two
    rescales, the update) for each update the d tier's callers make, into
    a strided view and a transposed view; then timed as dpotrf's top
    trailing update at 8192, C[4096:, 4096:] -= X·Xᵀ with one peel of the
    4096² panel for both sides."""
    n = 4096
    sc = torch.exp2(torch.randint(-3, 4, (n,), device="cuda",
                                  generator=gen).double())
    hi, lo = mm_groups_f32pair(Xs, Xs)
    big = torch.randn(n + 64, n + 64, dtype=torch.float64, device="cuda",
                      generator=gen)
    err = 0.0
    for alpha, beta in ((-1.0, 1.0), (1.0, 0.0), (1.0, 1.0), (0.5, 2.0)):
        for what, out in (("view", big[:n, 64:]), ("transposed view",
                                                    big[64:, :n].T)):
            want = epilogue_plain(hi, lo, sc, sc, out.clone(), alpha, beta)
            got = mm_groups_f64(Xs, sc, Xs, sc, out=out.clone(), alpha=alpha,
                                beta=beta)
            require(torch.equal(got, want),
                    f"mm_groups_f64 alpha={alpha} beta={beta} {what}: not "
                    f"bit for bit the twin's ({max_err(got, want)})")
            err = max(err, max_err(got, want))
    print("mm_groups_f64 4096³, S=6: bit for bit the twin's epilogue for "
          "alpha/beta -1/1, 1/0, 1/1, 0.5/2 into views")
    C = big[:n, 64:]
    ms = bench_op(lambda a: mm_groups_f64(a, sc, a, sc, out=C, alpha=-1.0,
                                          beta=1.0), Xs, reps=5) * 1e3
    plain_ms = bench_op(lambda a: epilogue_plain(
        *mm_groups_plain(a, a), sc, sc, C, -1.0, 1.0), Xs, reps=3) * 1e3
    # the composition the kernel replaced: the pair kernel, then the passes
    composed_ms = bench_op(lambda a: epilogue_plain(
        *mm_groups_f32pair(a, a), sc, sc, C, -1.0, 1.0), Xs, reps=5) * 1e3
    X64 = torch.randn(n, n, dtype=torch.float64, device="cuda",
                      generator=gen)
    lib_ms = bench_op(lambda a: C.sub_(a @ a.T), X64, reps=5) * 1e3
    # the f32 pair's bound with the f64 out read and written in its place
    rl = roofline(2 * n ** 3 * D_SLICES * (D_SLICES + 1) // 2, "int8",
                  D_SLICES * n * n + 16 * n * n)
    print(f"mm_groups_f64 4096³, C -= X·Xᵀ: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, mm_groups_f32pair and the torch passes "
          f"{composed_ms:.4f} ms, f64 C -= X @ X.T {lib_ms:.4f} ms, int8 "
          f"bound {rl['bound_ms']:.4f} ms on {on}")
    rec["mm_groups_f64"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, **rl)


def groups_roofline(m, n, k, one_peel=False, S=D_SLICES):
    """The bound of one grouped product: S(S+1)/2 int8 products of m·n·k
    multiply-adds; S bytes per element of each peel read (one peel when
    both sides share it), an f32 pair written."""
    return roofline(2 * m * n * k * S * (S + 1) // 2, "int8",
                    S * (m * k + (0 if one_peel else n * k)) + 8 * m * n)


FILL_N = 8192


def check_prng(rec, on):
    """The device fills at 8192², bit for bit against their twins (the
    same Philox words in int64 torch arithmetic), then the contract of the
    JAX package's fills: moments and range, the 2⁻⁵³ grid in f64, the four
    interval endpoints, and two adjacent seeds sharing no row block.
    Timed beside ``torch.rand`` on a CUDA generator, which never runs in
    the port."""
    n = FILL_N
    lib_gen = torch.Generator(device="cuda").manual_seed(0)
    for name, fill, plain, salt, dtype, device_fill in (
            ("uniform_fill_f32", uniform_fill_f32, uniform_fill_f32_plain, 0,
             torch.float32, uniform_device),
            ("uniform_fill_f64", uniform_fill_f64, uniform_fill_f64_plain,
             rng_device.SALT_F64, torch.float64, uniform_device64)):
        seeds = rng_device._mix_seeds(11, n // 256, salt).cuda()
        got = fill(seeds, n, n)
        want = plain(seeds, n, n)
        require(got.dtype == dtype and torch.equal(got, want),
                f"{name}: not bit for bit the twin's (max diff "
                f"{max_err(got, want):.3e})")
        del want
        lo, hi = float(got.min()), float(got.max())
        mean = float(got.double().mean())
        var = float(got.double().var())
        se = (1.0 / 12.0 / n ** 2) ** 0.5
        require(0.0 <= lo and hi < 1.0, f"{name}: range [{lo}, {hi}]")
        require(abs(mean - 0.5) < 6 * se and abs(var - 1 / 12) < 6 * (
            1 / 180 / n ** 2) ** 0.5, f"{name}: mean {mean}, var {var}")
        grid = ""
        if dtype == torch.float64:
            s53 = got * 2.0 ** 53
            require(torch.equal(s53, torch.round(s53)),
                    f"{name}: off the 2^-53 grid")
            grid = ", on the 2^-53 grid"
            del s53
        del got
        # the intervals, through the public fill
        ends = []
        for interval in Interval:
            u = device_fill(3, (n, 1024), interval)
            a, b = float(u.min()), float(u.max())
            ok = {Interval.CLOSED: 0 <= a and b <= 1,
                  Interval.OPEN: 0 < a and b < 1,
                  Interval.HALF_OPEN_01: 0 <= a and b < 1,
                  Interval.HALF_OPEN_10: 0 < a and b <= 1}[interval]
            require(ok, f"{name} {interval.value}: min {a}, max {b}")
            ends.append(f"{interval.value} [{a:.3e}, {1 - b:.3e} from 1]")
        # adjacent seeds: no shared row block, no correlation
        u1, u2 = device_fill(41, (n, 1024)), device_fill(42, (n, 1024))
        shared = [(i, j) for i in range(n // 256) for j in range(n // 256)
                  if torch.equal(u1[256 * i:256 * (i + 1)],
                                 u2[256 * j:256 * (j + 1)])]
        c = float(torch.corrcoef(torch.stack(
            [u1.double().flatten(), u2.double().flatten()]))[0, 1])
        require(not shared and abs(c) < 6 / (n * 1024) ** 0.5,
                f"{name}: seeds 41 and 42 share row blocks {shared[:3]}, "
                f"correlation {c}")
        del u1, u2
        ms = bench_op(lambda x: fill(x, n, n), seeds) * 1e3
        plain_ms = bench_op(lambda x: plain(x, n, n), seeds, warmup=1,
                            reps=3) * 1e3
        lib_ms = bench_op(lambda _: torch.rand(
            n, n, generator=lib_gen, device="cuda", dtype=dtype), seeds) * 1e3
        print(f"{name} {n}²: bit for bit the twin's; min {lo:.3e}, max "
              f"{hi:.9f}, mean {mean:.6f}, var {var:.6f} (1/12 = "
              f"{1 / 12:.6f}){grid}; intervals {'; '.join(ends)}; seeds 41 "
              f"and 42 share no row block, correlation {c:.2e}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.rand "
              f"{lib_ms:.4f} ms on {on}")
        # bound by the stores: Philox's integer operations, about 25 per
        # f32 element, take less than the store time at the card's int32
        # issue rate, and the table of peaks has no int32 entry
        rec[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         **roofline(0.0, "f32", n * n * (
                             4 if dtype == torch.float32 else 8)))


#: the GP cells' shapes (benchmark/configs/gp-kin8nm.json): n training
#: points, d features, m test points a prediction
RBF_N, RBF_D, RBF_M = 8192, 8, 819
#: rbf_f32's K against the twin's (tests/test_torch_cuda.py): D bit for
#: bit, -0.5·D, /ell2 and amp· correctly rounded in both, expf within 2 ulp
RBF_K_ULPS = 2


def ulps(a, b) -> int:
    """The largest |a − b| in units in the last place, a and b float32 of
    one sign: the distance of their bit patterns."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def rbf_device_ms(fn, match: str, reps: int = 10) -> float:
    """Device ms a call of fn: the kernels whose name holds ``match`` over
    ``reps`` calls in one profiled window, their union over reps."""
    busy, runs = profiling.device_time(
        lambda: [fn() for _ in range(reps)], match)["busy"]
    require(runs >= reps, f"{match}: {runs} kernels for {reps} calls")
    return busy / reps


def check_rbf(gen, rec, on):
    """The GP model's RBF kernels at the GP cells' shapes: rbf_f32's D bit
    for bit and its K within RBF_K_ULPS of the twin's for K (the diagonal
    added), Ks and Kss; rbf_grad_f32 on the pieces of a train step against
    the twin's sums and an f64 evaluation of the same W and K, repeated
    bit for bit; each kernel's call and device time beside its byte bound
    and the twin's time."""
    n, d, m = RBF_N, RBF_D, RBF_M
    p = gp.GPParams.init()
    X = torch.rand(n, d, device="cuda", generator=gen) * 2.0 - 1.0
    Xs = torch.rand(m, d, device="cuda", generator=gen) * 2.0 - 1.0
    worst, worst_abs = 0, 0.0
    for what, X1, X2, noise in (("K", X, X, (p.log_noise,)),
                                ("Ks", X, Xs, ()), ("Kss", Xs, Xs, ())):
        D = rbf.sqdist_f32(X1, X2)
        require(torch.equal(D, rbf.sqdist_plain(X1, X2)),
                f"rbf_f32 {what}: D is not the twin's bit for bit")
        K = rbf.rbf_f32(X1, X2, p.log_amp, p.log_len, *noise, jitter=1e-6)
        want = rbf.rbf_plain(X1, X2, p.log_amp, p.log_len, *noise,
                             jitter=1e-6)
        u = ulps(K, want)
        require(u <= RBF_K_ULPS and bool((K > 0).all()),
                f"rbf_f32 {what}: {u} ulps from the twin's")
        require(torch.equal(rbf.rbf_f32(X1, X2, p.log_amp, p.log_len,
                                        *noise, jitter=1e-6), K),
                f"rbf_f32 {what}: a second call differs")
        worst, worst_abs = max(worst, u), max(worst_abs, max_err(K, want))
        print(f"rbf_f32 {what} {tuple(K.shape)}, d={d}: D bit for bit the "
              f"twin's, K within {u} ulps (limit {RBF_K_ULPS}), repeated "
              "bit for bit")
        del D, K, want
    args = (p.log_amp, p.log_len, p.log_noise)
    cases = (("K", X, X, args), ("Ks", X, Xs, args[:2]))
    for what, X1, X2, a in cases:
        ms = bench_op(lambda _: rbf.rbf_f32(X1, X2, *a, jitter=1e-6),
                      X1) * 1e3
        dev = rbf_device_ms(lambda: rbf.rbf_f32(X1, X2, *a, jitter=1e-6),
                            "rbf_kernel")
        plain_ms = bench_op(lambda _: rbf.rbf_plain(X1, X2, *a, jitter=1e-6),
                            X1, reps=3) * 1e3
        rows, cols = X1.shape[0], X2.shape[0]
        live = rows * (rows + 1) // 2 if X2 is X1 else rows * cols
        rl = roofline(live * (3 * d + 4), "f32",
                      rows * cols * 4 + (rows + cols) * d * 4)
        print(f"rbf_f32 {what} {rows}x{cols}: call {ms:.4f} ms, device "
              f"{dev:.4f} ms, bound {rl['bound_ms']:.4f} ms "
              f"({rl['bound_by']}), plain {plain_ms:.4f} ms on {on}")
        if what == "K":
            rec["rbf_f32"] = dict(max_abs_err=worst_abs, ms=ms,
                                  device_ms=dev, plain_ms=plain_ms,
                                  library_ms=None, **rl)

    # the gradient sums on the pieces of a train step at the cells' n
    y = torch.sin(3.0 * X.sum(1) / math.sqrt(d)) + 0.1 * torch.randn(
        n, device="cuda", generator=gen)
    F, info = ct.potrf("L", gp._kmatrix(p, X))
    require(int(info) == 0, "rbf_grad_f32 inputs: potrf info")
    z = ct.trsm("L", "L", "N", "N", 1.0, F, y[:, None])
    alpha = ct.trsm("L", "L", "T", "N", 1.0, F, z)[:, 0]
    Kinv_tri = ct.potri("L", F)[0]
    del F, z
    got = rbf.rbf_grad_f32(Kinv_tri, alpha, X, *p)
    twin = rbf.rbf_grad_plain(Kinv_tri, alpha, X, *p)
    p64 = [v.double() for v in p]
    ref = rbf.rbf_grad_plain(Kinv_tri.double(), alpha.double(), X.double(),
                         *p64)
    again = rbf.rbf_grad_f32(Kinv_tri, alpha, X, *p)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "rbf_grad_f32: a second call differs")
    errs = []
    for name, a, t, r in zip(gp.GPParams._fields, got, twin, ref):
        e, et = abs(float(a) - float(r)), abs(float(t) - float(r))
        errs.append(e)
        print(f"rbf_grad_f32 n={n} d={d} g_{name.removeprefix('log_')}: "
              f"{float(a):.6f}, f64 {float(r):.6f}: err {e:.3e}, the "
              f"twin's {et:.3e}")
    ms = bench_op(lambda k: rbf.rbf_grad_f32(k, alpha, X, *p),
                  Kinv_tri) * 1e3
    dev = rbf_device_ms(lambda: rbf.rbf_grad_f32(Kinv_tri, alpha, X, *p),
                        "rbf_grad")
    plain_ms = bench_op(lambda k: rbf.rbf_grad_plain(k, alpha, X, *p),
                        Kinv_tri, reps=3) * 1e3
    live = n * (n + 1) // 2
    rl = roofline(live * (3 * d + 12), "f32", live * 4 + n * (d + 1) * 4)
    print(f"rbf_grad_f32 n={n} d={d}: repeated bit for bit; call {ms:.4f} "
          f"ms, device {dev:.4f} ms, bound {rl['bound_ms']:.4f} ms "
          f"({rl['bound_by']}), plain {plain_ms:.4f} ms on {on}")
    rec["rbf_grad_f32"] = dict(max_abs_err=max(errs), ms=ms, device_ms=dev,
                               plain_ms=plain_ms, library_ms=None, **rl)


# ---------------------------------------------------------------------------
# phase 4: the potrf path through the public API
# ---------------------------------------------------------------------------

def backward_error(F, A, uplo="L"):
    L = torch.tril(F) if uplo == "L" else torch.triu(F).T
    L = L.double()
    return float((L @ L.T - A.double()).abs().max())


def run_path(name, fn, exact=None):
    """Drive one path with every launch counter at 0; returns what fn
    returns and the path's launch counts, which must be > 0 for each
    kernel PATHS gives it, and equal to ``exact`` where it says."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"{name} launches: {launches}")
    require(all(launches[k] > 0 for k in PATHS[name]),
            f"{name}: a kernel of the path was not launched: {launches}")
    require(all(launches[k] == v for k, v in (exact or {}).items()),
            f"{name}: launches {launches}, expected {exact}")
    return out, launches


def main_path(gen, name_power):
    inputs = {n: spd(gen, n) for n in (4096, 8192)}
    out, launches = run_path("potrf", lambda: {
        n: (ct.potrf("L", A), ct.logdet("L", A)) for n, A in inputs.items()})
    for n, ((F, info), (ld, info2)) in out.items():
        A = inputs[n]
        require(int(info) == 0 and int(info2) == 0,
                f"potrf n={n}: info {int(info)}, logdet info {int(info2)}")
        be = backward_error(F, A)
        b = bound(n, float(A.abs().max()))
        require(be <= b, f"potrf n={n}: backward error {be} > {b}")
        ref = float(torch.linalg.slogdet(A.double())[1])
        rel = abs(float(ld) - ref) / abs(ref)
        require(rel <= n * EPS32, f"logdet n={n}: rel err {rel}")
        print(f"spotrf n={n}: info 0, max|LLᵀ-A| {be:.3e} (bound {b:.3e}); "
              f"logdet {float(ld):.6f} vs f64 slogdet {ref:.6f}, rel err "
              f"{rel:.3e} (bound n·eps {n * EPS32:.3e})")
    del out
    # the blocked recursion over 512 leaves, as a block size asks
    A = inputs[4096]
    (F, info), blocked = run_path(
        "potrf block_size=512", lambda: ct.potrf("L", A, block_size=512))
    be = backward_error(F, A)
    require(int(info) == 0 and be <= bound(4096, float(A.abs().max())),
            f"potrf block_size=512: info {int(info)}, backward error {be}")
    print(f"spotrf n=4096 block_size=512: info 0, max|LLᵀ-A| {be:.3e}")
    # upper at n = 1024 (one whole-matrix launch)
    A = A1024 = spd(gen, 1024)
    F, info = ct.potrf("U", A)
    be = backward_error(F, A, "U")
    require(int(info) == 0 and be <= bound(1024, float(A.abs().max())),
            f"potrf U n=1024: info {int(info)}, backward error {be}")
    print(f"spotrf U n=1024: info 0, max|UᵀU-A| {be:.3e}")
    # non-PD at n = 4096: the first bad pivot, and the leading block right
    A = inputs[4096].clone()
    A[3000, 3000] = -1.0
    F, info = ct.potrf("L", A)
    require(int(info) == 3001, f"non-PD n=4096: info {int(info)} != 3001")
    be = backward_error(F[:3000, :3000], A[:3000, :3000])
    require(be <= bound(4096, float(A.abs().max())),
            f"non-PD leading block: backward error {be}")
    print(f"spotrf non-PD n=4096 A[3000,3000]=-1: info 3001, leading "
          f"3000 block max|LLᵀ-A| {be:.3e}")
    # rates, beside torch.linalg.cholesky (oracle and yardstick); at 1024
    # potrf is one potrf_stream_f32 launch
    for n, A in {1024: A1024, **inputs}.items():
        t = bench_op(lambda a: ct.potrf("L", a), A, reps=5)
        t_ref = bench_op(lambda a: torch.linalg.cholesky(a), A, reps=5)
        t_blk = bench_op(lambda a: ct.potrf("L", a, block_size=512), A,
                         reps=5)
        print(f"spotrf n={n}: port {flops_potrf(n) / t / 1e9:.1f} GF/s "
              f"({t * 1e3:.3f} ms), torch.linalg.cholesky "
              f"{flops_potrf(n) / t_ref / 1e9:.1f} GF/s ({t_ref * 1e3:.3f} "
              f"ms); port with block_size=512 "
              f"{flops_potrf(n) / t_blk / 1e9:.1f} GF/s ({t_blk * 1e3:.3f} "
              f"ms) on {name_power}")
    return {"potrf": launches, "potrf block_size=512": blocked}


# ---------------------------------------------------------------------------
# phase 5: the GP model's train step and prediction, n = 8192, d = 8
# ---------------------------------------------------------------------------

GP_N, GP_D, GP_M = 8192, 8, 1024


def gp_linalg(params, X, y, dtype, route="cholesky_inverse"):
    """NLL and gradients of the same model on torch.linalg (cuSOLVER) in
    ``dtype``: the f64 oracle, and in f32 the yardsticks. K⁻¹ comes from
    ``torch.cholesky_inverse``, or with route="potri" from the algorithm
    the port and LAPACK's potri use, W = L⁻¹ by a triangular solve against
    the identity and then WᵀW. Never the port."""
    p = [v.to(dtype) for v in params]
    X, y = X.to(dtype), y.to(dtype)
    n = X.shape[0]
    amp, ell2 = torch.exp(2.0 * p[0]), torch.exp(2.0 * p[1])
    noise = torch.exp(2.0 * p[2])
    D = gp._sqdist(X, X)
    Kf = amp * torch.exp(-0.5 * D / ell2)
    K = Kf.clone()
    K.diagonal().add_(noise + 1e-6)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    nll = 0.5 * (torch.sum(z * z) + 2.0 * torch.log(L.diagonal()).sum()
                 + n * math.log(2.0 * math.pi))
    if route == "potri":
        Wi = torch.linalg.solve_triangular(
            L, torch.eye(n, dtype=dtype, device=L.device), upper=False)
        Kinv = Wi.T @ Wi
    else:
        Kinv = torch.cholesky_inverse(L)
    W = Kinv - alpha[:, None] * alpha[None, :]
    grads = (0.5 * torch.sum(W * 2.0 * Kf),
             0.5 * torch.sum(W * Kf * (D / ell2)),
             0.5 * torch.trace(W) * 2.0 * noise)
    return nll, grads


def linalg_step(params, X, y, lr):
    nll, g = gp_linalg(params, X, y, torch.float32)
    return [p - lr * gi for p, gi in zip(params, g)], nll


#: the port's error may be at most this multiple of the worse of the two
#: f32 torch.linalg yardsticks' errors on the same quantity
YARD_MULT = 4.0


def held(yard_err, limit):
    """The stated limit, or twice the f32 torch.linalg yardstick's own
    error where that yardstick misses the limit."""
    return limit if yard_err <= limit else 2.0 * yard_err


def wall_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3


def gemm_census(fn):
    """One call of fn under torch.profiler with every gemm_f32 launch noted
    on its way to the library (a proxy for _build.library): returns
    [((m, n, k, A layout, B layout, tile), device ms)] in launch order,
    each launch's time from the profiler's gemm kernel of the same rank."""
    real, lib, shapes = _build.library, _build.library(), []

    class Proxy:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ct_gemm_f32(*args):
            m, n, k = args[12:15]
            tile, a_kf, b_kf = args[17:20]
            shapes.append((m, n, k, "N" if a_kf else "T",
                           "T" if b_kf else "N", tile))
            return lib.ct_gemm_f32(*args)

    def once():             # the census is that of the window's last run
        shapes.clear()
        fn()

    _build.library = Proxy
    try:
        _, events = profiling.kernel_events(once)
    finally:
        _build.library = real
    runs = [(b - a) / 1e3 for name, a, b in events
            if "gemm64_kernel" in name or "gemm128_kernel" in name]
    require(len(runs) == len(shapes), f"gemm census: {len(shapes)} launches, "
            f"{len(runs)} kernels in the trace")
    return list(zip(shapes, runs))


def print_gemm_census(census, on, top=6):
    """The gemm_f32 launches of one GP train step by (m, n, k, layouts), with
    the tile the launch rule chose, then the top shapes timed alone on both
    tiles (CUDA events, fresh operands of the same layouts)."""
    by = {}
    for key, ms in census:
        c, t = by.get(key, (0, 0.0))
        by[key] = (c + 1, t + ms)
    rows = sorted(by.items(), key=lambda r: -r[1][1])
    print(f"gemm_f32 census of one GP train step: {len(census)} launches, "
          f"{sum(t for _, (_, t) in rows):.3f} ms of device time; (m, n, k), "
          f"A and B layouts (N row-major, T transposed), the tile chosen:")
    for (m, n, k, la, lb, tile), (c, t) in rows:
        print(f"  {m:5d} {n:5d} {k:5d} {la}{lb} {tile:3d}  {c:4d} launches  "
              f"{t:9.3f} ms")
    g = torch.Generator(device="cuda").manual_seed(11)
    for (m, n, k, la, lb, tile), _ in rows[:top]:
        A = (torch.randn(k, m, device="cuda", generator=g).T if la == "T"
             else torch.randn(m, k, device="cuda", generator=g))
        B = (torch.randn(n, k, device="cuda", generator=g).T if lb == "T"
             else torch.randn(k, n, device="cuda", generator=g))
        t = {}
        for edge in (128, 64):
            keep = gemm_tile_on(edge)
            try:
                t[edge] = bench_op(lambda a: gemm_f32(a, B), A, reps=10) * 1e3
            finally:
                kgemm.GEMM128_MIN_TILES = keep
        lib_ms = bench_op(lambda a: torch.matmul(a, B), A, reps=10) * 1e3
        print(f"  gemm_f32 {m}x{n}·{k} {la}{lb}: 128-tile {t[128]:.4f} ms, "
              f"64-tile {t[64]:.4f} ms (the rule: {tile}), torch.matmul "
              f"{lib_ms:.4f} ms on {on}")


def kernel_census(fn, on, name, match):
    """The launches of kernel ``name`` in one call of fn (its launch
    counter) and their device time: the union of the intervals of
    torch.profiler's CUDA kernels whose name holds ``match``."""
    wrapper = kernels.KERNELS[name]
    launches = 0

    def once():             # the census is that of the window's last run
        nonlocal launches
        before = wrapper.launches
        fn()
        launches = wrapper.launches - before

    busy, runs = profiling.device_time(once, match)["busy"]
    require(launches > 0 and runs, f"{name} census: no launch")
    print(f"{name} census of one GP train step: {launches} launches "
          f"({runs} kernels in the trace), {busy:.3f} ms of device "
          f"time, {busy / launches:.4f} ms a launch on {on}")
    return launches, busy


def gp_path(name_power, dev="cuda"):
    g = torch.Generator(device=dev).manual_seed(1)
    X = torch.rand(GP_N, GP_D, device=dev, generator=g) * 2.0 - 1.0
    w = torch.randn(GP_D, device=dev, generator=g)
    y = torch.sin(3.0 * X @ w / math.sqrt(GP_D)) + 0.1 * torch.randn(
        GP_N, device=dev, generator=g)
    Xs = torch.rand(GP_M, GP_D, device=dev, generator=g) * 2.0 - 1.0
    F4 = torch.tril(ct.potrf("L", spd(g, 4096, 30.0))[0])
    A2 = torch.tril(ct.potrf("L", spd(g, 2048, 30.0))[0])
    p0 = gp.GPParams.init(device=dev)

    def train_and_predict():
        nll0, g0, info0 = gp.gp_nll_and_grads(p0, X, y)
        # a step of 0.05 in the largest coordinate: plain gradient steps
        # at lr = 1e-2 overshoot at n = 8192, where the gradients grow
        # with n
        lr = 0.05 / max(abs(float(v)) for v in g0)
        p, nlls, infos = p0, [], []
        for _ in range(3):
            p, nll, info = gp.gp_train_step(p, X, y, lr=lr)
            nlls.append(float(nll))
            infos.append(int(info))
        mean, var, info_p = gp.gp_predict(p, X, y, Xs)
        return nll0, g0, info0, lr, p, nlls, infos, mean, var, info_p

    (nll0, g0, info0, lr, p, nlls, infos, mean, var, info_p), gp_l = \
        run_path("GP", train_and_predict)

    # the train steps: info 0, a decreasing NLL
    require(int(info0) == 0 and infos == [0, 0, 0] and int(info_p) == 0,
            f"GP info {int(info0)}, steps {infos}, predict {int(info_p)}")
    require(nlls[0] > nlls[1] > nlls[2],
            f"GP NLL does not decrease over three steps: {nlls}")
    print(f"GP n={GP_N} d={GP_D}: lr {lr:.4e}; three train steps, info 0 "
          f"each, NLL {nlls[0]:.4f} > {nlls[1]:.4f} > {nlls[2]:.4f}; "
          f"params {[round(float(v), 6) for v in p]}")

    # the first step against the f64 oracle, beside two f32 yardsticks:
    # torch.cholesky_inverse, and potri's own algorithm on torch.linalg
    nll64, g64 = gp_linalg(p0, X, y, torch.float64)
    nll32, g32 = gp_linalg(p0, X, y, torch.float32)
    _, g32p = gp_linalg(p0, X, y, torch.float32, route="potri")
    rel = abs(float(nll0) - float(nll64)) / abs(float(nll64))
    rel32 = abs(float(nll32) - float(nll64)) / abs(float(nll64))
    lim = held(rel32, 1e-3)
    require(rel <= lim and rel <= YARD_MULT * rel32,
            f"GP NLL rel err {rel} > {lim} or > {YARD_MULT}x {rel32}")
    print(f"GP NLL {float(nll0):.6f} vs f64 {float(nll64):.6f}: rel err "
          f"{rel:.3e} (f32 torch.linalg {rel32:.3e}; limits {lim:.1e} and "
          f"{YARD_MULT:g}x the yardstick)")
    for name, a, r, y32, y32p in zip(gp.GPParams._fields, g0, g64, g32,
                                     g32p):
        scale = max(1.0, abs(float(r)))
        e = abs(float(a) - float(r))
        e32, e32p = abs(float(y32) - float(r)), abs(float(y32p) - float(r))
        lim = held(e32, 1e-2 * scale)
        lim_y = YARD_MULT * max(e32, e32p)
        require(e <= lim and e <= lim_y,
                f"GP gradient {name}: err {e} > {lim} or > {lim_y}")
        print(f"GP gradient {name} {float(a):.6f} vs f64 {float(r):.6f}: "
              f"err {e:.3e} (f32 torch.linalg: cholesky_inverse {e32:.3e}, "
              f"potri's algorithm {e32p:.3e}; limits {lim:.3e} and "
              f"{lim_y:.3e})")

    # the prediction against the f64 posterior on the same parameters
    K64 = gp._kmatrix(gp.GPParams(*(v.double() for v in p)), X.double())
    L64 = torch.linalg.cholesky(K64)
    Ks64 = gp.rbf_kernel(gp.GPParams(*(v.double() for v in p)), X.double(),
                         Xs.double())
    a64 = torch.cholesky_solve(y.double()[:, None], L64)[:, 0]
    V64 = torch.linalg.solve_triangular(L64, Ks64, upper=False)
    mean64 = Ks64.T @ a64
    var64 = torch.exp(2.0 * p[0].double()) - torch.sum(V64 * V64, dim=0)
    require(mean.shape == var.shape == (GP_M,)
            and bool(torch.isfinite(mean).all() & torch.isfinite(var).all()),
            "GP predict: shape or finiteness")
    em, ev = max_err(mean, mean64), max_err(var, var64)
    lm = 1e-2 * max(1.0, float(mean64.abs().max()))
    lv = 1e-2 * max(1.0, float(var64.abs().max()))
    require(em <= lm and ev <= lv, f"GP predict: mean err {em}, var err {ev}")
    print(f"GP predict on {GP_M} points: mean err {em:.3e} (limit {lm:.3e}), "
          f"var err {ev:.3e} (limit {lv:.3e}) against f64")
    del K64, L64, Ks64, V64

    # potri on the whole-matrix route, held against the f64 inverse beside
    # both f32 yardsticks on the same factor
    (inv4, info4), potri_l = run_path("potri", lambda: ct.potri("L", F4))
    require(int(info4) == 0, "potri n=4096 info")
    inv64 = torch.cholesky_inverse(F4.double())
    W4 = torch.linalg.solve_triangular(
        F4, torch.eye(4096, device=dev), upper=False)
    yards = {"cholesky_inverse": torch.cholesky_inverse(F4),
             "potri's algorithm": W4.T @ W4}
    low = torch.ones(4096, 4096, dtype=torch.bool, device=dev).tril_()

    def errs(R):
        d = torch.where(low, R.double() - inv64, 0.0)
        return (float(d.abs().max()),
                float(d.norm() / torch.where(low, inv64, 0.0).norm()))

    e4, r4 = errs(inv4)
    ye = {k: errs(v) for k, v in yards.items()}
    lim4 = YARD_MULT * max(v[0] for v in ye.values())
    require(e4 <= lim4 and r4 <= 1e-4,
            f"potri n=4096: err {e4} > {lim4} or relative {r4} > 1e-4")
    print(f"potri n=4096: max err {e4:.3e}, relative Frobenius {r4:.3e} vs "
          f"f64 cholesky_inverse; f32 yardsticks "
          + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in ye.items())
          + f"; limits {lim4:.3e} and 1e-4")
    del yards, W4

    # lauum on 512 leaves
    lau2, lauum_l = run_path("lauum block_size=512",
                             lambda: ct.lauum("L", A2, block_size=512))
    e2 = max_err(torch.tril(lau2), lauum_stream_plain(A2))
    b2 = bound(2 * 2048 + 3, float(lau2.abs().max()))
    require(e2 <= b2, f"lauum block_size=512 n=2048: err {e2} > {b2}")
    print(f"lauum n=2048 on 512 leaves: max err {e2:.3e} (bound {b2:.3e})")

    print_gemm_census(gemm_census(lambda: gp.gp_train_step(p0, X, y, lr=lr)),
                      name_power)
    for name, match in (("trtri_block_f32", "trtri_block"),
                        ("trtri_stream_f32", "trtri_stream"),
                        ("lauum_stream_f32", "lauum"),
                        ("rbf_f32", "rbf_kernel"),
                        ("rbf_grad_f32", "rbf_grad")):
        kernel_census(lambda: gp.gp_train_step(p0, X, y, lr=lr), name_power,
                      name, match)

    # times, beside torch.linalg yardsticks (never the port)
    step_ms = wall_ms(lambda: gp.gp_train_step(p0, X, y, lr=lr))
    yard_ms = wall_ms(lambda: linalg_step(p0, X, y, lr))
    print(f"GP train step n={GP_N} d={GP_D}: port {step_ms:.3f} ms, f32 "
          f"torch.linalg {yard_ms:.3f} ms on {name_power}")
    fl = 2 * 4096 ** 3 / 3
    t = bench_op(lambda f: ct.potri("L", f), F4, reps=5)
    t_ref = bench_op(lambda f: torch.cholesky_inverse(f), F4, reps=5)
    print(f"spotri n=4096: port {fl / t / 1e9:.1f} GF/s ({t * 1e3:.3f} ms), "
          f"torch.cholesky_inverse {fl / t_ref / 1e9:.1f} GF/s "
          f"({t_ref * 1e3:.3f} ms) on {name_power}")
    return {"GP": gp_l, "potri": potri_l, "lauum block_size=512": lauum_l}


# ---------------------------------------------------------------------------
# phase 6: the d tier, dpotrf + dlogdet + dpotri at n = 8192 (BASELINE.json
# configs[1] and [3]), f64 under backend="auto"
# ---------------------------------------------------------------------------

D_N, D_COND = 8192, 100.0


def profile_table(fn, top=16, census=None):
    """One call of fn under torch.profiler: (wall ms, device busy ms, idle
    share, operations on the device, [(name, count, ms)] by device time).
    Busy is the union of the device intervals, so overlapping kernels
    count once. With a list ``census``, every mm_groups_f64 launch of the
    call is also recorded there as ((m, n, k), device ms), its shape
    read by the wrapper and its time from the profiler's kernel of the
    same rank in launch order."""
    real, shapes = ozaki._kz, []

    class Recorder:
        """ops/ozaki.py's view of the kernel module, noting each product's
        shape on its way to the real wrapper."""

        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def mm_groups_f64(As, ascale, Bs, bscale, **update):
            shapes.append((As.shape[1], Bs.shape[1], As.shape[2]))
            return real.mm_groups_f64(As, ascale, Bs, bscale, **update)

    def once():             # the census is that of the window's last run
        shapes.clear()
        fn()

    if census is not None:
        ozaki._kz = Recorder()
    try:
        wall, events = profiling.kernel_events(once)
    finally:
        ozaki._kz = real
    by_name, groups = {}, []
    for name, a, b in events:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + (b - a) / 1e3)
        if "mm_groups_kernel" in name:
            groups.append((b - a) / 1e3)
    if census is not None:
        require(len(groups) == len(shapes), f"census: {len(shapes)} "
                f"launches, {len(groups)} kernels in the trace")
        census.extend(zip(shapes, groups))
    busy = busy_ms([(a, b) for _, a, b in events])
    rows = sorted(((k, c, t) for k, (c, t) in by_name.items()),
                  key=lambda r: -r[2])
    return wall, busy, max(0.0, 1.0 - busy / wall), len(events), rows[:top]


def print_census(census, on, top=3):
    """The mm_groups_f64 launches of one call by (m, n, k), by device
    time, then the top shapes timed alone (CUDA events, fresh S = 6 peels
    of Gaussian f64 inputs, a new f64 result) beside one f64 torch.matmul
    of the same shape, with their int8 bound."""
    by = {}
    for shape, ms in census:
        c, t = by.get(shape, (0, 0.0))
        by[shape] = (c + 1, t + ms)
    rows = sorted(by.items(), key=lambda r: -r[1][1])
    total = sum(t for _, (_, t) in rows)
    print(f"mm_groups_f64 census: {len(census)} launches, {total:.3f} "
          f"ms of device time, {len(rows)} shapes (m, n, k):")
    for (m, n, k), (c, t) in rows:
        print(f"  {m:5d} {n:5d} {k:5d}  {c:4d} launches  {t:9.3f} ms")
    g = torch.Generator(device="cuda").manual_seed(7)
    for (m, n, k), _ in rows[:top]:
        A = torch.randn(m, k, dtype=torch.float64, device="cuda", generator=g)
        B = torch.randn(n, k, dtype=torch.float64, device="cuda", generator=g)
        As, asc = ozaki.split_rows(A, D_SLICES)
        Bs, bsc = ozaki.split_rows(B, D_SLICES)
        ms = bench_op(lambda a: mm_groups_f64(a, asc, Bs, bsc), As) * 1e3
        lib = bench_op(lambda a: torch.matmul(a, B.T), A) * 1e3
        rl = groups_roofline(m, n, k)
        print(f"  mm_groups_f64 {m}×{n}·{k}, S={D_SLICES}: kernel "
              f"{ms:.4f} ms, f64 torch.matmul {lib:.4f} ms, int8 bound "
              f"{rl['bound_ms']:.4f} ms on {on}")


def d_path(gen, name_power):
    n = D_N
    A = latmc(gen, n, D_COND, torch.float64)

    def drive():
        F, info = ct.dpotrf("L", A)
        ld, info_ld = ct.dlogdet("L", A)
        inv, info_inv = ct.dpotri("L", F)
        return F, info, ld, info_ld, inv, info_inv

    t0 = time.perf_counter()
    (F, info, ld, info_ld, inv, info_inv), launches = run_path("d", drive)
    first_s = time.perf_counter() - t0
    require(int(info) == int(info_ld) == int(info_inv) == 0,
            f"d path info: dpotrf {int(info)}, dlogdet {int(info_ld)}, "
            f"dpotri {int(info_inv)}")
    require(all(bool(torch.isfinite(x).all()) for x in (F, ld, inv)),
            "d path: non-finite output")

    # the gates, in f64 on the card against cuSOLVER's f64 torch.linalg
    L = torch.tril(F)
    scale = float(A.abs().max())
    be = float((L @ L.T - A).abs().max()) / scale
    b_be = n * 2.0 ** -40
    require(be <= b_be, f"dpotrf n={n}: max|LLᵀ-A|/max|A| {be} > {b_be}")
    ref_ld = float(torch.linalg.slogdet(A)[1])
    rel_ld = abs(float(ld) - ref_ld) / abs(ref_ld)
    require(rel_ld <= 1e-9, f"dlogdet n={n}: rel err {rel_ld} > 1e-9")
    L64 = torch.linalg.cholesky(A)
    inv64 = torch.cholesky_inverse(L64)
    low = torch.ones(n, n, dtype=torch.bool, device="cuda").tril_()
    rel_inv = float(torch.where(low, inv - inv64, 0.0).abs().max()) / float(
        inv64.abs().max())
    b_inv = D_COND * n * 2.0 ** -40
    require(rel_inv <= b_inv, f"dpotri n={n}: rel err {rel_inv} > {b_inv}")
    print(f"dpotrf n={n} cond {D_COND:g} (auto -> ozaki): info 0, "
          f"max|LLᵀ-A|/max|A| {be:.3e} (bound n·2^-40 {b_be:.3e}); dlogdet "
          f"{float(ld):.10f} vs f64 slogdet {ref_ld:.10f}, rel err "
          f"{rel_ld:.3e} (bound 1e-9); dpotri max err / max|A⁻¹| "
          f"{rel_inv:.3e} vs f64 cholesky_inverse (bound cond·n·2^-40 "
          f"{b_inv:.3e}); first run of the three {first_s:.3f} s")
    del inv, inv64, low

    # a non-positive-definite input: the first failing pivot, leading
    # block finite and right (the second pass, with the f64 rescue)
    B = A.clone()
    B[3000, 3000] = -1.0
    t0 = time.perf_counter()
    Fb, info_b = ct.dpotrf("L", B)
    torch.cuda.synchronize()
    t_nonpd = time.perf_counter() - t0
    lead = torch.tril(Fb[:3000, :3000])
    require(int(info_b) == 3001 and bool(torch.isfinite(lead).all()),
            f"non-PD n={n}: info {int(info_b)} != 3001 or leading block "
            "not finite")
    be_lead = float((lead @ lead.T - B[:3000, :3000]).abs().max()) / scale
    require(be_lead <= b_be, f"non-PD leading block: {be_lead} > {b_be}")
    print(f"dpotrf non-PD n={n} A[3000,3000]=-1: info 3001, leading 3000 "
          f"block finite, max|LLᵀ-A|/max|A| {be_lead:.3e}; {t_nonpd:.3f} s "
          "(two passes, the second with the f64 rescue)")
    del B, Fb, lead
    # PD in f64, singular in f32: the rescue re-factors the leaf in f64
    a = 0.5
    R = torch.tensor([[1.0, a], [a, a * a + 1e-12]], dtype=torch.float64,
                     device="cuda")
    Fr, info_r = ct.dpotrf("L", R)
    Lr = torch.tril(Fr)
    er = float((Lr @ Lr.T - R).abs().max())
    require(int(info_r) == 0 and er < 1e-15,
            f"f64 rescue: info {int(info_r)}, residual {er}")
    print(f"dpotrf 2×2 [[1, .5], [.5, .25 + 1e-12]]: info 0 (the f32 leaf "
          f"fails, the f64 rescue factors it), max|LLᵀ-A| {er:.3e}")

    # times beside cuSOLVER's f64 routines (never the port)
    t_potrf = wall_ms(lambda: ct.dpotrf("L", A))
    t_logdet = wall_ms(lambda: ct.dlogdet("L", A))
    t_potri = wall_ms(lambda: ct.dpotri("L", F))
    t_chol = bench_op(lambda a: torch.linalg.cholesky_ex(a), A, reps=5) * 1e3
    t_cinv = bench_op(lambda x: torch.cholesky_inverse(x), L64, reps=5) * 1e3
    fl = flops_potrf(n)
    print(f"dpotrf n={n}: port {t_potrf:.3f} ms ({fl / t_potrf / 1e6:.1f} "
          f"GF/s), f64 torch.linalg.cholesky_ex {t_chol:.3f} ms "
          f"({fl / t_chol / 1e6:.1f} GF/s); dlogdet {t_logdet:.3f} ms; "
          f"dpotri {t_potri:.3f} ms ({2 * n ** 3 / 3 / t_potri / 1e6:.1f} "
          f"GF/s), f64 torch.cholesky_inverse {t_cinv:.3f} ms "
          f"({2 * n ** 3 / 3 / t_cinv / 1e6:.1f} GF/s) on {name_power}")

    # where one dpotrf's time goes
    census = []
    wall, busy, idle, count, rows = profile_table(lambda: ct.dpotrf("L", A),
                                                  top=None, census=census)
    print(f"dpotrf n={n} under torch.profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {idle:.4f}, {count} operations "
          "on the device; by device time:")
    for name, count, ms in rows[:16]:
        print(f"  {ms:10.3f} ms  {count:6d}  {name[:160]}")
    for name, count, ms in rows:
        if "potrf_block_f32_kernel" in name:
            print(f"  the 128-wide leaves: {ms:.3f} ms over {count} "
                  f"potrf_block_f32 launches ({name[:60]})")
    print_census(census, name_power)

    # the f32-pair kernels, which the d path no longer launches: the JAX
    # package's composition (scale, peel the pair, grouped products) on a
    # 1024² block of the input
    def pair_products():
        rh, rl, _ = scaled_pair(A[:1024, :1024])
        Ss = peel_f32pair(rh, rl, slices=D_SLICES)
        return mm_groups_f32pair(Ss, Ss)

    _, pair = run_path("Ozaki pair", pair_products, exact("Ozaki pair"))
    return {"d": launches, "Ozaki pair": pair}


# ---------------------------------------------------------------------------
# phase 7: the BLAS path (strmm, sgemm, ssyrk, dtrmm) and the leaf routes
# (spotf2 at 16384, strtri with block_size=8192), each call on its own
# launch counters
# ---------------------------------------------------------------------------

B_N = 8192
TRTI2_N = 8320      # past STREAM_MAX_N: no whole-matrix kernel takes it
ONLY = dict.fromkeys(kernels.KERNELS, 0)


def only(**counts):
    """Exact launch counts: these, and 0 for every other kernel."""
    return {**ONLY, **counts}


def exact(name):
    """0 launches for every kernel outside the path ``name``."""
    return {k: 0 for k in ONLY if k not in PATHS[name]}


def strmm_operand(uplo, trans, diag, A, dtype):
    """op(T) in ``dtype``, T the uplo triangle of A (unit diagonal with
    diag U), materialized: the f64 reference's operand and the f32
    library call's."""
    T = A.to(dtype)
    T = torch.tril(T) if uplo == "L" else torch.triu(T)
    if diag == "U":
        T.diagonal().fill_(1.0)
    return T if trans == "N" else T.T


def llt64(F):
    L = torch.tril(F).double()
    return L @ L.T


def blas_path(gen, name_power):
    """Each call against an f64 reference, gated (``gated``) on the error
    of the f32 library call that computes the same function."""
    n = m = B_N
    runs = {}
    A = torch.randn(n, n, device="cuda", generator=gen)
    B = torch.randn(n, m, device="cuda", generator=gen)
    live = n * (n + 1) * m
    for side, uplo, trans, diag in (("L", "L", "N", "N"),
                                    ("L", "U", "N", "N"),
                                    ("L", "L", "T", "N"),
                                    ("L", "U", "T", "N"),
                                    ("R", "L", "N", "N"),
                                    ("L", "L", "N", "U")):
        form = side + uplo + trans + diag
        C, launches = run_path("strmm", lambda: ct.strmm(
            side, uplo, trans, diag, 1.0, A, B), only(trmm_lln_f32=1))
        runs.setdefault("strmm", launches)
        T64 = strmm_operand(uplo, trans, diag, A, torch.float64)
        ref = T64 @ B.double() if side == "L" else B.double() @ T64
        del T64
        T32 = strmm_operand(uplo, trans, diag, A, torch.float32)
        lib = T32 @ B if side == "L" else B @ T32
        e_lib = max_err(lib, ref)
        del T32, lib
        err, lim, rms = gated(f"strmm {form}", C, ref, e_lib, rms=rms_of(ref))
        del ref, C
        t = bench_op(lambda x: ct.strmm(side, uplo, trans, diag, 1.0, A, x),
                     B, reps=3)
        print(f"strmm {form} n=m={n}: max err vs f64 {err:.3e}, f32 "
              f"torch.matmul's {e_lib:.3e} (limit {lim:.3e}, 1/"
              f"{rms / lim:.0f} of the RMS {rms:.3e}); {t * 1e3:.3f} ms, "
              f"{live / t / 1e9:.1f} GF/s (live flops n(n+1)m)")
    Lt = torch.tril(A)
    t_lib = bench_op(lambda x: torch.matmul(Lt, x), B, reps=3)
    print(f"f32 torch.matmul(tril(A), B) n=m={n}: {t_lib * 1e3:.3f} ms, "
          f"{live / t_lib / 1e9:.1f} GF/s on the same live flops, on "
          f"{name_power}")

    # sgemm and ssyrk through the public API
    C = torch.randn(n, n, device="cuda", generator=gen)
    G, runs["sgemm"] = run_path("sgemm", lambda: ct.sgemm(
        "N", "T", 1.0, A, B, 0.5, C), only(gemm_f32=1))
    ref = A.double() @ B.double().T + 0.5 * C.double()
    e_lib = max_err(torch.addmm(C, A, B.T, beta=0.5), ref)
    err, lim, rms = gated(f"sgemm {n}³", G, ref, e_lib, rms=rms_of(ref))
    del G, ref
    t = bench_op(lambda x: ct.sgemm("N", "T", 1.0, x, B, 0.5, C), A, reps=3)
    t_lib = bench_op(lambda x: torch.addmm(C, x, B.T, beta=0.5), A, reps=3)
    print(f"sgemm {n}³ N,T: max err vs f64 {err:.3e}, torch.addmm's "
          f"{e_lib:.3e} (limit {lim:.3e}); {t * 1e3:.3f} ms "
          f"({2 * n ** 3 / t / 1e9:.1f} GF/s), torch.addmm {t_lib * 1e3:.3f} "
          f"ms ({2 * n ** 3 / t_lib / 1e9:.1f} GF/s)")
    S, runs["ssyrk"] = run_path("ssyrk", lambda: ct.ssyrk(
        "L", "N", -1.0, A, 1.0, C), only(syrk_lower_f32=1))
    require(torch.equal(torch.triu(S, 1), torch.triu(C, 1)),
            "ssyrk: the strict upper changed")
    ref = torch.tril(C.double() - A.double() @ A.double().T)
    e_lib = max_err(torch.tril(torch.addmm(C, A, A.T, alpha=-1.0)), ref)
    err, lim, rms = gated(f"ssyrk {n}", torch.tril(S), ref, e_lib)
    del S, ref
    t = bench_op(lambda x: ct.ssyrk("L", "N", -1.0, x, 1.0, C), A, reps=3)
    print(f"ssyrk n=k={n} L,N: max err vs f64 {err:.3e}, torch.addmm's "
          f"{e_lib:.3e} (limit {lim:.3e}), strict upper kept; "
          f"{t * 1e3:.3f} ms ({n * (n + 1) * n / t / 1e9:.1f} GF/s on the "
          "triangle)")
    del C

    # dtrmm under auto: the Ozaki kernels, never the f32 trmm
    A64, B64 = A.double(), B.double()
    D, runs["dtrmm"] = run_path("dtrmm", lambda: ct.dtrmm(
        "L", "L", "N", "N", 1.0, A64, B64), exact("dtrmm"))
    ref = torch.tril(A64) @ B64
    rel = float((D - ref).abs().max()) / float(ref.abs().max())
    require(rel <= n * 2.0 ** -40, f"dtrmm {n}: rel err {rel}")
    del D, ref
    t = wall_ms(lambda: ct.dtrmm("L", "L", "N", "N", 1.0, A64, B64))
    L64 = torch.tril(A64)
    t_lib = bench_op(lambda x: torch.matmul(L64, x), B64, reps=3) * 1e3
    print(f"dtrmm L,L,N,N n=m={n} (auto -> ozaki): max err / max|ref| "
          f"{rel:.3e} (bound n·2^-40 {n * 2.0 ** -40:.3e}); {t:.3f} ms wall, "
          f"f64 torch.matmul(tril(A), B) {t_lib:.3f} ms on {name_power}")
    del A64, B64, L64, A, B, Lt

    # spotf2 above the whole-matrix kernels: one potf2_f32 launch, on a
    # dense SPD input, its backward error gated on cuSOLVER's f32 factor's
    n2 = 2 * B_N
    A = dense_spd(gen, n2)
    (F, info), runs["spotf2"] = run_path("spotf2", lambda: ct.spotf2("L", A),
                                         only(potf2_f32=1))
    require(int(info) == 0, f"spotf2 n={n2}: info {int(info)}")
    A64 = A.double()
    be_lib = max_err(llt64(torch.linalg.cholesky_ex(A)[0]), A64)
    be, lim, rms = gated(f"spotf2 n={n2}: max|LLᵀ-A|", llt64(F), A64, be_lib)
    del F, A64
    t = bench_op(lambda a: ct.spotf2("L", a), A, reps=3)
    t_lib = bench_op(lambda a: torch.linalg.cholesky_ex(a), A, reps=3)
    print(f"spotf2 n={n2} dense cond 100: info 0, max|LLᵀ-A| {be:.3e}, "
          f"cuSOLVER f32's {be_lib:.3e} (limit {lim:.3e}, 1/{rms / lim:.0f} "
          f"of A's strict lower RMS {rms:.3e}); {t * 1e3:.3f} ms "
          f"({flops_potrf(n2) / t / 1e9:.1f} GF/s), f32 "
          f"torch.linalg.cholesky_ex {t_lib * 1e3:.3f} ms "
          f"({flops_potrf(n2) / t_lib / 1e9:.1f} GF/s) on {name_power}")
    A[1000, 1000] = -1.0
    F, info = ct.spotf2("L", A)
    require(int(info) == 1001 and bool(torch.isfinite(torch.tril(F)).all()),
            f"spotf2 non-PD: info {int(info)}, or not finite")
    lead = A[:1000, :1000]
    be_lib = max_err(llt64(torch.linalg.cholesky_ex(lead)[0]), lead)
    be, _, _ = gated("spotf2 non-PD leading block: max|LLᵀ-A|",
                     llt64(F[:1000, :1000]), lead.double(), be_lib)
    print(f"spotf2 non-PD n={n2} A[1000,1000]=-1: info 1001, finite, "
          f"leading block max|LLᵀ-A| {be:.3e}, cuSOLVER f32's {be_lib:.3e}")
    del A, F, lead

    # strtri with one block: at 8192 one launch of the kernel the tuning
    # table routes a block of 8192 to (PATHS), at 8320, past the
    # whole-matrix kernels' cap, one trti2_f32 launch; unit and not, on a
    # dense factor (its leading block at 8192), gated on f32
    # solve_triangular's error
    F, info = ct.potrf("L", dense_spd(gen, TRTI2_N))
    require(int(info) == 0, f"strtri input factor: info {int(info)}")
    Lw = torch.tril(F)
    del F
    for n, path in ((B_N, "strtri block_size=8192"),
                    (TRTI2_N, "strtri n=8320 block_size=8320")):
        L = Lw[:n, :n].contiguous()
        eye32 = torch.eye(n, device="cuda")
        for diag in ("N", "U"):
            X = L if diag == "N" else unit_form(L)
            (W, info), launches = run_path(
                path, lambda: ct.strtri("L", diag, X, block_size=n),
                only(**dict.fromkeys(PATHS[path], 1)))
            runs.setdefault(path, launches)
            require(int(info) == 0, f"strtri {diag} n={n}: info {int(info)}")
            ref = inverse64(X, diag == "U")
            lib = torch.linalg.solve_triangular(X, eye32, upper=False,
                                                unitriangular=diag == "U")
            if diag == "U":
                lib.diagonal().copy_(torch.diagonal(X))
            e_lib = max_err(lib, ref)
            del lib
            err, lim, rms = gated(f"strtri {diag} n={n} block_size={n}",
                                  torch.tril(W), ref, e_lib)
            del W, ref
            t = bench_op(lambda x: ct.strtri("L", diag, x, block_size=n), X,
                         reps=3)
            t_lib = bench_op(lambda x: torch.linalg.solve_triangular(
                x, eye32, upper=False, unitriangular=diag == "U"), X, reps=3)
            print(f"strtri L,{diag} n={n} block_size={n} ("
                  f"{', '.join(PATHS[path])}): max err vs f64 {err:.3e}, "
                  f"f32 solve_triangular's {e_lib:.3e} (limit {lim:.3e}, "
                  f"1/{rms / lim:.0f} of the strict lower's RMS "
                  f"{rms:.3e}); {t * 1e3:.3f} ms, f32 solve_triangular(L, "
                  f"I) {t_lib * 1e3:.3f} ms on {name_power}")
        del L, eye32
    return runs


# ---------------------------------------------------------------------------
# phase 8: the c/z tier through the real embedding, n = 4096 complex
# (BASELINE.json configs[2], "zpotrf/zpotri N=4096 Hermitian")
# ---------------------------------------------------------------------------

CZ_N, CZ_COND, CZ_K, CZ_BLAS_N = 4096, 100.0, 512, 2048


def as_c128(X):
    return (torch.complex(*X) if isinstance(X, tuple) else X).to(
        torch.complex128)


def yard(what, err, yard_err, scale):
    """err within F32_GATE times a c64 yardstick's error on the same
    input (and at least one ulp of ``scale``); returns the limit."""
    lim = F32_GATE * max(yard_err, EPS32 * scale)
    require(err <= lim, f"{what}: err {err:.3e} > {lim:.3e} ({F32_GATE:g}x "
            f"the c64 yardstick's {yard_err:.3e})")
    return lim


def crandn(gen, *shape):
    return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                       generator=gen)


def cz_path(gen, name_power):
    n = CZ_N
    t_phase = time.perf_counter()
    runs = {}
    low = torch.ones(n, n, dtype=torch.bool, device="cuda").tril_()

    # z: an HPD pair of f64 planes, auto -> the embedding -> the d tier
    Ap = latmc_pair(gen, n, CZ_COND, torch.float64)
    A = as_c128(Ap)
    scale = float(A.abs().max())

    def z_drive():
        F, info = ct.zpotrf("L", Ap)
        ld, info_ld = ct.zlogdet("L", Ap)
        inv, info_inv = ct.zpotri("L", F)
        return F, info, ld, info_ld, inv, info_inv

    (Fz, info, ld, info_ld, inv, info_inv), runs["z"] = run_path(
        "z", z_drive, exact("z"))
    require(int(info) == int(info_ld) == int(info_inv) == 0,
            f"z path info: zpotrf {int(info)}, zlogdet {int(info_ld)}, "
            f"zpotri {int(info_inv)}")
    Lz = torch.tril(as_c128(Fz))
    be = float((Lz @ Lz.mH - A).abs().max()) / scale
    b_be = n * 2.0 ** -40
    require(be <= b_be, f"zpotrf n={n}: max|LLᴴ-A|/max|A| {be} > {b_be}")
    ref_ld = float(torch.linalg.slogdet(A)[1])
    rel_ld = abs(float(ld) - ref_ld) / abs(ref_ld)
    require(rel_ld <= 1e-9, f"zlogdet n={n}: rel err {rel_ld} > 1e-9")
    L128 = torch.linalg.cholesky(A)
    inv128 = torch.cholesky_inverse(L128)
    rel_inv = float(torch.where(low, as_c128(inv) - inv128, 0).abs().max()) \
        / float(inv128.abs().max())
    b_inv = CZ_COND * n * 2.0 ** -40
    require(rel_inv <= b_inv, f"zpotri n={n}: rel err {rel_inv} > {b_inv}")
    print(f"zpotrf n={n} complex ({2 * n} real) cond {CZ_COND:g}, a pair "
          f"under auto -> embed -> ozaki: info 0, max|LLᴴ-A|/max|A| {be:.3e} "
          f"(bound n·2^-40 {b_be:.3e}); zlogdet {float(ld):.10f} vs c128 "
          f"slogdet {ref_ld:.10f}, rel err {rel_ld:.3e} (bound 1e-9); zpotri "
          f"max err / max|A⁻¹| {rel_inv:.3e} (bound cond·n·2^-40 "
          f"{b_inv:.3e})")
    del inv, Lz

    # a non-HPD c128 tensor: info as cuSOLVER's
    B = A.clone()
    B[3000, 3000] = -1.0
    _, info_b = ct.zpotrf("L", B)
    info_ref = int(torch.linalg.cholesky_ex(B).info)
    require(int(info_b) == info_ref == 3001,
            f"zpotrf non-HPD: info {int(info_b)}, cholesky_ex {info_ref}")
    print(f"zpotrf non-HPD c128 tensor A[3000,3000]=-1: info {int(info_b)}, "
          f"torch.linalg.cholesky_ex info {info_ref}")
    del B

    # ztrsm on right-hand sides made by the f64 fill, as a pair
    def z_solve():
        Bp = (uniform_device64(21, (n, CZ_K)), uniform_device64(22, (n, CZ_K)))
        return Bp, ct.ztrsm("L", "L", "N", "N", 1.0, Fz, Bp)

    (Bz, Xz), runs["ztrsm"] = run_path("ztrsm", z_solve, exact("ztrsm"))
    Xref = torch.linalg.solve_triangular(L128, as_c128(Bz), upper=False)
    rel_x = float((as_c128(Xz) - Xref).abs().max()) / float(
        Xref.abs().max())
    require(rel_x <= b_inv, f"ztrsm: rel err {rel_x} > {b_inv}")
    print(f"ztrsm L,L,N,N n={n} k={CZ_K}, right-hand sides from "
          f"uniform_device64 as a pair: max err / max|X| {rel_x:.3e} (bound "
          f"{b_inv:.3e})")
    del Xz, Xref

    # times beside cuSOLVER and cuBLAS in c128 (never the port)
    t_zpotrf = wall_ms(lambda: ct.zpotrf("L", Ap))
    t_zlogdet = wall_ms(lambda: ct.zlogdet("L", Ap))
    t_zpotri = wall_ms(lambda: ct.zpotri("L", Fz))
    t_ztrsm = wall_ms(lambda: ct.ztrsm("L", "L", "N", "N", 1.0, Fz, Bz))
    t_chol = wall_ms(lambda: torch.linalg.cholesky_ex(A))
    t_cinv = wall_ms(lambda: torch.cholesky_inverse(L128))
    B128 = as_c128(Bz)
    t_solve = wall_ms(lambda: torch.linalg.solve_triangular(
        L128, B128, upper=False))
    print(f"zpotrf n={n}: port {t_zpotrf:.3f} ms, c128 "
          f"torch.linalg.cholesky_ex {t_chol:.3f} ms; zlogdet "
          f"{t_zlogdet:.3f} ms; zpotri {t_zpotri:.3f} ms, c128 "
          f"torch.cholesky_inverse {t_cinv:.3f} ms; ztrsm k={CZ_K} "
          f"{t_ztrsm:.3f} ms, c128 solve_triangular {t_solve:.3f} ms "
          f"(host clock, synchronized) on {name_power}")
    wall, busy, idle, count, rows = profile_table(lambda: ct.zpotrf("L", Ap),
                                                  top=8)
    print(f"zpotrf n={n} under torch.profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {idle:.4f}, {count} operations "
          "on the device; by device time:")
    for name, cnt, ms in rows:
        print(f"  {ms:10.3f} ms  {cnt:6d}  {name[:160]}")
    del Fz, Bz, B128, L128, inv128, Ap

    # c: an HPD c64 tensor, auto -> the embedding -> the f32 kernels
    Ac = A.to(torch.complex64)
    del A
    (Fc, info), runs["cpotrf"] = run_path(
        "cpotrf", lambda: ct.cpotrf("L", Ac), only(potrf_stream_f32=1))
    (ldc, info_ld), _ = run_path("cpotrf", lambda: ct.clogdet("L", Ac),
                                 only(potrf_stream_f32=1))
    require(int(info) == int(info_ld) == 0, "cpotrf/clogdet info")
    A = as_c128(Ac)
    scale = float(A.abs().max())
    ref_ld = float(torch.linalg.slogdet(A)[1])
    Lc = torch.tril(as_c128(Fc))
    be = float((Lc @ Lc.mH - A).abs().max())
    b_be = bound(2 * n, scale)
    require(be <= b_be, f"cpotrf n={n}: max|LLᴴ-A| {be} > {b_be}")
    rel_ld = abs(float(ldc) - ref_ld) / abs(ref_ld)
    require(rel_ld <= 2 * n * EPS32, f"clogdet: rel err {rel_ld}")
    L128 = torch.linalg.cholesky(A)
    inv128 = torch.cholesky_inverse(L128)
    (invc, info), runs["cpotri"] = run_path("cpotri",
                                            lambda: ct.cpotri("L", Fc),
                                            exact("cpotri"))
    require(int(info) == 0, "cpotri info")
    # beside two c64 yardsticks, as spotri: cholesky_inverse, and potri's
    # own algorithm (W = L⁻¹ by a solve against I, then WᴴW), whose
    # explicit inverse multiplies the error by about cond(L)
    def inv_err(R):
        return float(torch.where(low, as_c128(R) - inv128, 0).abs().max())

    e_inv = inv_err(invc)
    Lt = torch.tril(Fc)
    Wc = torch.linalg.solve_triangular(Lt, torch.eye(
        n, dtype=Lt.dtype, device="cuda"), upper=False)
    e_yards = (inv_err(torch.cholesky_inverse(Lt)), inv_err(Wc.mH @ Wc))
    del Wc
    lim_inv = yard("cpotri", e_inv, max(e_yards), float(inv128.abs().max()))
    print(f"cpotrf n={n} c64 tensor under auto -> embed -> potrf_stream_f32 "
          f"(one launch at {2 * n}): max|LLᴴ-A| {be:.3e} (bound 2n·2·eps "
          f"{b_be:.3e}); clogdet rel err {rel_ld:.3e} (bound 2n·eps "
          f"{2 * n * EPS32:.3e}); cpotri max err {e_inv:.3e}, c64 "
          f"torch.cholesky_inverse's {e_yards[0]:.3e}, potri's algorithm's "
          f"{e_yards[1]:.3e} (limit {lim_inv:.3e})")
    del invc, Lc

    # ctrsm on right-hand sides made by the f32 fill, as a pair
    Fcp = (Fc.real.contiguous(), Fc.imag.contiguous())

    def c_solve():
        Bp = (uniform_device(23, (n, CZ_K)), uniform_device(24, (n, CZ_K)))
        return Bp, ct.ctrsm("L", "L", "N", "N", 1.0, Fcp, Bp)

    (Bc, Xc), runs["ctrsm"] = run_path("ctrsm", c_solve, exact("ctrsm"))
    Bc64 = torch.complex(*Bc)
    Xref = torch.linalg.solve_triangular(torch.tril(as_c128(Fc)),
                                         as_c128(Bc64), upper=False)
    e_lib = max_err(torch.linalg.solve_triangular(torch.tril(Fc), Bc64,
                                                    upper=False), Xref)
    err, lim, rms = gated("ctrsm", as_c128(Xc), Xref, e_lib,
                          rms=rms_of(Xref.abs()))
    print(f"ctrsm L,L,N,N n={n} k={CZ_K}, right-hand sides from "
          f"uniform_device as a pair: max err {err:.3e}, c64 "
          f"solve_triangular's {e_lib:.3e} (limit {lim:.3e}, 1/"
          f"{rms / lim:.0f} of the RMS {rms:.3e})")
    t_cpotrf = wall_ms(lambda: ct.cpotrf("L", Ac))
    t_clogdet = wall_ms(lambda: ct.clogdet("L", Ac))
    t_cpotri = wall_ms(lambda: ct.cpotri("L", Fc))
    t_ctrsm = wall_ms(lambda: ct.ctrsm("L", "L", "N", "N", 1.0, Fcp, Bc))
    t_chol = wall_ms(lambda: torch.linalg.cholesky_ex(Ac))
    t_cinv = wall_ms(lambda: torch.cholesky_inverse(Lt))
    t_solve = wall_ms(lambda: torch.linalg.solve_triangular(Lt, Bc64,
                                                            upper=False))
    print(f"cpotrf n={n}: port {t_cpotrf:.3f} ms, c64 "
          f"torch.linalg.cholesky_ex {t_chol:.3f} ms; clogdet "
          f"{t_clogdet:.3f} ms; cpotri {t_cpotri:.3f} ms, c64 "
          f"torch.cholesky_inverse {t_cinv:.3f} ms; ctrsm k={CZ_K} "
          f"{t_ctrsm:.3f} ms, c64 solve_triangular {t_solve:.3f} ms (host "
          f"clock, synchronized) on {name_power}")
    del Ac, A, Fc, Fcp, Bc, Bc64, Xc, Xref, L128, inv128, Lt, low

    # cgemm, cherk and ctrmm at 2048 on dense inputs: gemm_f32 only
    m = CZ_BLAS_N
    X, Y, C = crandn(gen, m, m), crandn(gen, m, m), crandn(gen, m, m)
    X128, Y128, C128 = as_c128(X), as_c128(Y), as_c128(C)
    al, be_ = 1.5 - 0.5j, 0.5
    G, runs["cgemm"] = run_path("cgemm", lambda: ct.cgemm(
        "N", "C", al, X, Y, be_, C), exact("cgemm"))
    ref = al * X128 @ Y128.mH + be_ * C128
    e_lib = max_err(torch.addmm(C, X, Y.mH, beta=be_, alpha=al), ref)
    err_g, lim_g, _ = gated("cgemm", as_c128(G), ref, e_lib,
                            rms=rms_of(ref.abs()))
    H, runs["cherk"] = run_path("cherk", lambda: ct.cherk(
        "L", "N", 1.0, X, be_, C), exact("cherk"))
    Ch = torch.tril(C128) + torch.tril(C128, -1).mH
    Ch.diagonal().imag.zero_()
    ref = torch.tril(X128 @ X128.mH + be_ * Ch)
    ref.diagonal().imag.zero_()
    e_lib = max_err(torch.tril(torch.addmm(Ch.to(torch.complex64), X,
                                             X.mH, beta=be_)), ref)
    err_h, lim_h, _ = gated("cherk", torch.tril(as_c128(H)), ref, e_lib,
                            rms=rms_of(ref.abs()))
    require(bool((H.diagonal().imag == 0).all()) and torch.equal(
        torch.triu(H, 1), torch.triu(C, 1)),
        "cherk: the diagonal is not real or the strict upper changed")
    T, runs["ctrmm"] = run_path("ctrmm", lambda: ct.ctrmm(
        "L", "L", "N", "N", 1.0, X, Y), exact("ctrmm"))
    ref = torch.tril(X128) @ Y128
    e_lib = max_err(torch.tril(X) @ Y, ref)
    err_t, lim_t, _ = gated("ctrmm", as_c128(T), ref, e_lib,
                            rms=rms_of(ref.abs()))
    t_g = wall_ms(lambda: ct.cgemm("N", "C", al, X, Y, be_, C))
    t_h = wall_ms(lambda: ct.cherk("L", "N", 1.0, X, be_, C))
    t_t = wall_ms(lambda: ct.ctrmm("L", "L", "N", "N", 1.0, X, Y))
    t_mm = wall_ms(lambda: torch.addmm(C, X, Y.mH, beta=be_, alpha=al))
    t_tr = wall_ms(lambda: torch.tril(X) @ Y)
    print(f"cgemm/cherk/ctrmm n={m}: max err vs c128 {err_g:.3e} / "
          f"{err_h:.3e} / {err_t:.3e} (limits 8x the c64 library's: "
          f"{lim_g:.3e} / {lim_h:.3e} / {lim_t:.3e}), cherk's diagonal "
          f"real and strict upper kept; {t_g:.3f} / {t_h:.3f} / {t_t:.3f} "
          f"ms, c64 torch.addmm {t_mm:.3f} ms, torch.matmul(tril(A), B) "
          f"{t_tr:.3f} ms (host clock) on {name_power}")
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 10: the block-cyclic tier (cholesky_tpu_torch.parallel) on one
# NCCL rank: potrf/logdet at n = 16384, trsm with 16 right-hand sides,
# potri at 8192, f64 potrf at 4096 under auto, a non-PD input
# ---------------------------------------------------------------------------

DIST_N, DIST_NB, DIST_NRHS, DIST_POTRI_N, DIST_D_N = 16384, 256, 16, 8192, 4096


def dist_blocks(n: int) -> int:
    """nblk of a world of one: n padded to a multiple of nb. Every step
    factors one diagonal block (potrf_block_f32, the block-0 prologue and
    one lookahead per step but the last) and inverts it (trtri_block_f32):
    nblk launches of each per factorization; trtri_dist inverts each
    diagonal block once: nblk trtri_block_f32 launches."""
    return -(-n // DIST_NB)


def run_dist(name, fn, exact):
    """run_path with the collective counts at 0 before and printed after."""
    par_comm.reset_counts()
    out, launches = run_path(name, fn, exact)
    print(f"{name} collectives: {par_comm.counts()}")
    return out, launches


def dist_path(gen, name_power):
    """The block-cyclic tier through its entry points on a one-rank NCCL
    group (the card machine has one card: no scaling is measured), each
    call on its own launch counters and beside the single-device driver
    and cuSOLVER at the same n."""
    t_phase = time.perf_counter()
    launch.init_single("cuda")
    try:
        runs = dist_calls(gen, name_power)
    finally:
        dist.destroy_process_group()
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return runs


def dist_calls(gen, name_power):
    n, nb, nblk = DIST_N, DIST_NB, dist_blocks(DIST_N)
    A = dense_spd(gen, n)
    one = {"potrf_block_f32": nblk, "trtri_block_f32": nblk,
           "potrf_stream_f32": 0}
    (F, info), launches = run_dist(
        "dist potrf", lambda: par.potrf_sharded("L", A, nb=nb), one)
    require(int(info) == 0, f"potrf_sharded n={n}: info {int(info)}")
    be = backward_error(F, A)
    b = bound(n, float(A.abs().max()))
    require(be <= b, f"potrf_sharded n={n}: backward error {be} > {b}")
    bc = par.distribute(A, nb=nb)
    (ld, info_ld), _ = run_dist("dist logdet",
                                lambda: par.logdet_dist(bc), one)
    ld_ref, info_ref = ct.logdet("L", A)
    rel = abs(float(ld) - float(ld_ref)) / abs(float(ld_ref))
    require(int(info_ld) == int(info_ref) == 0 and rel <= n * EPS32,
            f"logdet_dist n={n}: info {int(info_ld)}, rel err {rel}")
    print(f"potrf_sharded n={n} nb={nb} (one NCCL rank, lookahead): info 0,"
          f" max|LLᵀ-A| {be:.3e} (bound {b:.3e}); logdet_dist "
          f"{float(ld):.6f} vs ct.logdet {float(ld_ref):.6f}, rel err "
          f"{rel:.3e} (bound n·eps {n * EPS32:.3e})")

    # solves through the distributed factor, 16 right-hand sides, against
    # f64 solves of the same factor, gated on f32 solve_triangular's error
    fbc, _ = par.potrf_dist(bc)
    B = torch.randn(n, DIST_NRHS, device="cuda", generator=gen)
    L32 = torch.tril(par.collect(fbc))
    L64 = L32.double()
    sols = {}
    for trans in ("N", "T"):
        X, _ = run_dist(f"dist trsm {trans}", lambda: par.trsm_factor_dist(
            fbc, B, trans), {k: 0 for k in kernels.KERNELS})
        up = trans == "T"
        ref = torch.linalg.solve_triangular(L64.T if up else L64, B.double(),
                                            upper=up)
        yard = max_err(torch.linalg.solve_triangular(
            L32.T if up else L32, B, upper=up), ref)
        sols[trans] = (*gated(f"trsm_factor_dist {trans} n={n}", X, ref,
                              yard, rms=float(ref.square().mean().sqrt())),
                       yard)
    print(f"trsm_factor_dist n={n} nrhs={DIST_NRHS} against f64 solves of "
          "the same factor: " + "; ".join(
              f"{t} err {e:.3e}, solve_triangular's {y:.3e} (limit {lim:.3e}"
              f", 1/{rms / lim:.0f} of the solution's RMS {rms:.3e})"
              for t, (e, lim, rms, y) in sols.items()))
    del L32, L64

    times = {
        "potrf_sharded": bench_op(lambda a: par.potrf_sharded(
            "L", a, nb=nb), A, reps=5),
        "potrf_dist": bench_op(lambda a: par.potrf_dist(bc), A, reps=5),
        "logdet_dist": bench_op(lambda a: par.logdet_dist(bc), A, reps=5),
        "ct.potrf": bench_op(lambda a: ct.potrf("L", a), A, reps=5),
        "ct.logdet": bench_op(lambda a: ct.logdet("L", a), A, reps=5),
        "cholesky_ex": bench_op(lambda a: torch.linalg.cholesky_ex(a), A,
                                reps=5),
        "trsm_factor_dist N": bench_op(
            lambda x: par.trsm_factor_dist(fbc, x, "N"), B, reps=5),
        "trsm_factor_dist T": bench_op(
            lambda x: par.trsm_factor_dist(fbc, x, "T"), B, reps=5),
        "solve_triangular": bench_op(
            lambda x: torch.linalg.solve_triangular(F, x, upper=False), B,
            reps=5),
    }
    print(f"phase 10 times at n={n}, nb={nb}, ms (CUDA events, median of 5):"
          + "".join(f" {k} {v * 1e3:.4f};" for k, v in times.items())
          + f" on {name_power}")
    # where one potrf_dist's time goes
    wall, busy, idle, count, rows = profile_table(lambda: par.potrf_dist(bc),
                                                  top=8)
    print(f"potrf_dist n={n} under torch.profiler: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {idle:.4f}, {count} "
          "operations on the device; by device time:")
    for name, count, ms in rows:
        print(f"  {ms:10.3f} ms  {count:6d}  {name[:160]}")
    del fbc, bc, F, A, B

    # potri at 8192 from a factor of the single-device driver
    n2 = DIST_POTRI_N
    A2 = dense_spd(gen, n2)
    F2, _ = ct.potrf("L", A2)
    (Inv, info), potri = run_dist(
        "dist potri", lambda: par.potri_sharded("L", F2, nb=nb),
        {"trtri_block_f32": dist_blocks(n2), "potrf_block_f32": 0,
         "potrf_stream_f32": 0})
    # against the f64 inverse of the same factor, gated on f32
    # cholesky_inverse's error; ct.potri's error beside it
    L2 = torch.tril(F2)
    ref64 = torch.tril(torch.cholesky_inverse(L2.double()))
    yard = max_err(torch.tril(torch.cholesky_inverse(L2)), ref64)
    ref, info_ref = ct.potri("L", F2)
    require(int(info) == int(info_ref) == 0,
            f"potri_sharded n={n2}: info {int(info)}, ct.potri "
            f"{int(info_ref)}")
    err, lim, rms = gated(f"potri_sharded n={n2}", torch.tril(Inv), ref64,
                          yard)
    err_ct = max_err(torch.tril(ref), ref64)
    t_potri = bench_op(lambda f: par.potri_sharded("L", f, nb=nb), F2,
                       reps=3)
    t_ct = bench_op(lambda f: ct.potri("L", f), F2, reps=3)
    t_lib = bench_op(lambda f: torch.cholesky_inverse(f), F2, reps=3)
    print(f"potri_sharded n={n2}: info 0, max err vs f64 {err:.3e}, "
          f"cholesky_inverse's {yard:.3e}, ct.potri's {err_ct:.3e} (limit "
          f"{lim:.3e}, 1/{rms / lim:.0f} of the strict lower's RMS "
          f"{rms:.3e}); {t_potri * 1e3:.4f} ms, ct.potri "
          f"{t_ct * 1e3:.4f}, torch.cholesky_inverse {t_lib * 1e3:.4f} on "
          f"{name_power}")
    del A2, F2, L2, Inv, ref, ref64

    # f64 under auto: the d tier's kernels on every diagonal and product
    n3 = DIST_D_N
    A3 = latmc(gen, n3, D_COND, torch.float64)
    (F3, info), d = run_dist(
        "dist d", lambda: par.potrf_sharded("L", A3, nb=nb),
        {"potrf_block_f32": dist_blocks(n3),
         "trtri_block_f32": dist_blocks(n3)})
    L3 = torch.tril(F3)
    be3 = float((L3 @ L3.T - A3).abs().max()) / float(A3.abs().max())
    require(int(info) == 0 and be3 <= n3 * 2.0 ** -40,
            f"f64 potrf_sharded n={n3}: info {int(info)}, max|LLᵀ-A|/max|A| "
            f"{be3} > n·2^-40")
    t_d = bench_op(lambda a: par.potrf_sharded("L", a, nb=nb), A3, reps=3)
    t_dct = bench_op(lambda a: ct.potrf("L", a), A3, reps=3)
    t_dlib = bench_op(lambda a: torch.linalg.cholesky_ex(a), A3, reps=5)
    print(f"f64 potrf_sharded n={n3} (auto -> ozaki): info 0, "
          f"max|LLᵀ-A|/max|A| {be3:.3e} (bound n·2^-40 "
          f"{n3 * 2.0 ** -40:.3e}); {t_d * 1e3:.4f} ms, ct.potrf "
          f"{t_dct * 1e3:.4f} ms, f64 cholesky_ex {t_dlib * 1e3:.4f} ms "
          f"(CUDA events) on {name_power}")
    del A3, F3, L3

    # a non-positive-definite f32 input: info as the single-device driver's
    A4 = dense_spd(gen, 4096)
    A4[3000, 3000] = -1.0
    F4, info = par.potrf_sharded("L", A4, nb=nb)
    _, info_ref = ct.potrf("L", A4)
    require(int(info) == int(info_ref) == 3001,
            f"non-PD potrf_sharded: info {int(info)}, ct.potrf "
            f"{int(info_ref)}")
    lead = F4[:3000, :3000]
    be4 = backward_error(lead, A4[:3000, :3000])
    require(be4 <= bound(4096, float(A4.abs().max())),
            f"non-PD potrf_sharded leading block: backward error {be4}")
    print(f"potrf_sharded non-PD n=4096 A[3000,3000]=-1: info 3001 as "
          f"ct.potrf's, leading 3000 block max|LLᵀ-A| {be4:.3e}")
    return {"dist potrf": launches, "dist potri": potri, "dist d": d}


# ---------------------------------------------------------------------------
# phase 11: the multi-device tier's part (b) on one NCCL rank: the
# distributed GP train step (models/gp_dist.py) at n_train = 8192, d = 8,
# the distributed BLAS (parallel/blas.py) and the dry run (entry.py)
# ---------------------------------------------------------------------------

GPD_N, GPD_D, GPD_BATCH, GPD_PROBES, GPD_STEPS = 8192, 8, 2, 2, 3
DBLAS_N, DBLAS_D_N = 8192, 4096


def gp_dist_data(gen, batch: int, n: int, d: int, probes: int):
    """The dry run's kind of data at (batch, n, d): Gaussian X, y =
    sin(X[..., 0]) + 0.1 noise, Rademacher probes."""
    X = torch.randn(batch, n, d, device="cuda", generator=gen)
    y = torch.sin(X[..., 0]) + 0.1 * torch.randn(batch, n, device="cuda",
                                                 generator=gen)
    Z = torch.randint(0, 2, (batch, n, probes), device="cuda",
                      generator=gen).float().mul_(2.0).sub_(1.0)
    return X, y, Z


def hutchinson(params, X, y, Z, dtype):
    """The distributed step's mean (nll, ∂/∂log_amp, ∂/∂log_len,
    ∂/∂log_noise) over the batch on torch.linalg in ``dtype`` (cholesky,
    cholesky_solve with the same probes): the f64 oracle, and in f32 the
    library yardstick."""
    amp, ell2, noise = (torch.exp(2.0 * v.to(dtype)) for v in params)
    out = torch.zeros(4, dtype=dtype, device="cuda")
    for Xb, yb, Zb in zip(X.to(dtype), y.to(dtype), Z.to(dtype)):
        n = Xb.shape[0]
        D = torch.zeros(n, n, dtype=dtype, device="cuda")
        for f in range(Xb.shape[1]):
            dd = Xb[:, f, None] - Xb[None, :, f]
            D += dd * dd
        Kf = amp * torch.exp(-0.5 * D / ell2)
        K = Kf.clone()
        K.diagonal().add_(noise + 1e-6)
        L = torch.linalg.cholesky(K)
        del K
        sol = torch.cholesky_solve(torch.cat([yb[:, None], Zb], 1), L)
        alpha, U = sol[:, 0], sol[:, 1:]
        ld = 2.0 * torch.log(L.diagonal()).sum()
        del L

        def grad(dK):
            return 0.5 * ((U * (dK @ Zb)).sum(0).mean()
                          - alpha @ (dK @ alpha))

        out += torch.stack([
            0.5 * (yb @ alpha + ld + n * math.log(2.0 * math.pi)),
            grad(2.0 * Kf), grad(Kf * (D / ell2)),
            0.5 * ((U * Zb).sum(0).mean() - alpha @ alpha) * 2.0 * noise])
    return out / X.shape[0]


def gp_dist_counts(nblk: int, local_batch: int, steps: int = 1) -> dict:
    """The collectives of ``steps`` train steps on one rank: for each
    problem potrf_dist's, the log-determinant's all_reduce and the two
    solves'; then one all_reduce and one all_gather over the dp group."""
    return {"broadcast": steps * local_batch * (4 * nblk - 1),
            "all_reduce": steps * (local_batch * nblk + 1),
            "all_gather": steps * (local_batch * (nblk - 1) + 1)}


def gp_dist_gates(what, got, ref64, ref32):
    """Each of (nll, three gradients) against the f64 oracle, gated on the
    f32 library computation's error (``gated``, the limit below 1 % of
    the oracle's size)."""
    names = ("nll", "g_amp", "g_len", "g_noise")
    out = []
    for i, name in enumerate(names[:len(got)]):
        r = ref64[i]
        err, lim, _ = gated(f"{what} {name}", got[i], r,
                            max_err(ref32[i], r), rms=float(r.abs()))
        out.append(f"{name} {float(got[i]):.6f} vs f64 {float(r):.6f}, err "
                   f"{err:.3e}, f32 torch.linalg's "
                   f"{max_err(ref32[i], r):.3e} (limit {lim:.3e})")
    return "; ".join(out)


def gp_dist_step_path(gen, name_power):
    """The distributed GP train step on a (1, 1) mesh of the one-rank NCCL
    group: gradients at the initial parameters from one step at lr = 1
    (params − params' gives them back to f32's rounding of params'), then
    three steps at lr = 0.05 / max|g| on their own counters, each nll
    gated; times beside ct.potrf + two ct.trsm of the same problems."""
    from cholesky_tpu_torch.models import make_gp_train_step
    n, d, batch, nb = GPD_N, GPD_D, GPD_BATCH, DIST_NB
    nblk = dist_blocks(n)
    X, y, Z = gp_dist_data(gen, batch, n, d, GPD_PROBES)
    mesh = launch.mesh2d(1, 1)
    p0 = gp.GPParams.init()
    ref64, ref32 = (hutchinson(p0, X, y, Z, dt)
                    for dt in (torch.float64, torch.float32))
    unit = make_gp_train_step(mesh, n, d, batch, nb=nb,
                              n_probes=GPD_PROBES, lr=1.0)
    p1, nll, infos = unit(p0, X, y, Z)
    require(infos.tolist() == [0] * batch, f"dist GP infos {infos.tolist()}")
    got = [nll.double()] + [a.double() - b.double() for a, b in zip(p0, p1)]
    print(f"dist GP n={n} d={d} batch={batch} nb={nb} (one NCCL rank): "
          "at the initial parameters " + gp_dist_gates(
              "dist GP step", got, ref64, ref32))

    lr = 0.05 / float(ref64[1:].abs().max())
    step = make_gp_train_step(mesh, n, d, batch, nb=nb, n_probes=GPD_PROBES,
                              lr=lr)

    def train():
        p, out = p0, []
        for _ in range(GPD_STEPS):
            p_in = p
            p, nll, infos = step(p, X, y, Z)
            out.append((p_in, nll, infos))
        return p, out

    blocks = GPD_STEPS * batch * nblk
    (p, steps), launches = run_dist(
        "dist GP", train, {"potrf_block_f32": blocks,
                           "trtri_block_f32": blocks, "potrf_stream_f32": 0})
    want = gp_dist_counts(nblk, batch, GPD_STEPS)
    require(par_comm.counts() == want,
            f"dist GP collectives {par_comm.counts()}, expected {want}")
    for i, (p_in, nll, infos) in enumerate(steps):
        require(infos.tolist() == [0] * batch,
                f"dist GP step {i}: infos {infos.tolist()}")
        r64, r32 = (hutchinson(p_in, X, y, Z, dt)
                    for dt in (torch.float64, torch.float32))
        print(f"dist GP step {i} (lr {lr:.4e}): infos 0, "
              + gp_dist_gates(f"dist GP step {i}", [nll.double()], r64, r32))
    require(all(bool(torch.isfinite(v)) for v in p), f"dist GP params {p}")
    print(f"dist GP params after {GPD_STEPS} steps: "
          f"{[round(float(v), 6) for v in p]}")

    # times: the step, and the single-device factor and two solves of the
    # same problems (their kernel matrices made before the clock starts)
    Ks = [gp._kmatrix(p0, Xb) for Xb in X]
    rhs = torch.cat([y[..., None], Z], dim=2)

    def single(_):
        for K, R in zip(Ks, rhs):
            F, _ = ct.potrf("L", K)
            ct.trsm("L", "L", "T", "N", 1.0, F,
                    ct.trsm("L", "L", "N", "N", 1.0, F, R))

    t_step = bench_op(lambda x: step(p0, x, y, Z), X, reps=5)
    t_single = bench_op(single, X, reps=5)
    t_factor = bench_op(lambda x: [par.potrf_dist(par.distribute(K, nb=nb))
                                   for K in Ks], X, reps=5)
    print(f"dist GP step n={n} batch={batch}: {t_step * 1e3:.4f} ms; "
          f"distribute + potrf_dist of both problems {t_factor * 1e3:.4f} ms; "
          f"single-device ct.potrf + two ct.trsm of both {t_single * 1e3:.4f}"
          f" ms (CUDA events, median of 5) on {name_power}")
    del Ks, rhs
    wall, busy, idle, count, rows = profile_table(lambda: step(p0, X, y, Z),
                                                  top=8)
    print(f"dist GP step under torch.profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {idle:.4f}, {count} operations "
          "on the device; by device time:")
    for name, c, ms in rows:
        print(f"  {ms:10.3f} ms  {c:6d}  {name[:160]}")
    return {"dist GP": launches}


def dist_blas_path(gen, name_power):
    """One call of each distributed BLAS routine on dense inputs, each on
    its own launch and collective counters (one all_gather a call), held
    against f64 (f32 and c64 under ``gated``, f64 within n·2^-40 of the
    reference's size, the d tier's rule) and timed beside the single-device
    call and one PyTorch call."""
    n, runs, lines = DBLAS_N, {}, []
    one_gather = {"broadcast": 0, "all_reduce": 0, "all_gather": 1}

    def call(path, fn, exact_counts):
        out, runs[path] = run_dist(path, fn, exact_counts)
        require(par_comm.counts() == one_gather,
                f"{path}: collectives {par_comm.counts()}")
        return out

    def times(label, dist_fn, ct_fn, lib_fn, x, reps=3):
        t = [bench_op(f, x, reps=reps) * 1e3 for f in (dist_fn, ct_fn,
                                                        lib_fn)]
        lines.append(f"{label}: {t[0]:.4f} ms, single-device {t[1]:.4f}, "
                     f"torch {t[2]:.4f}")

    A = torch.randn(n, n, device="cuda", generator=gen)
    B = torch.randn(n, n, device="cuda", generator=gen)
    C = torch.randn(n, n, device="cuda", generator=gen)
    G = call("dist gemm", lambda: par.gemm_dist("N", "N", 1.0, A, B, 0.5, C),
             only())
    ref = A.double() @ B.double() + 0.5 * C.double()
    e_lib = max_err(torch.addmm(C, A, B, beta=0.5), ref)
    err, lim, _ = gated(f"gemm_dist {n}³", G, ref, e_lib, rms=rms_of(ref))
    del G, ref
    print(f"gemm_dist N,N {n}³ f32: max err vs f64 {err:.3e}, torch.addmm's "
          f"{e_lib:.3e} (limit {lim:.3e})")
    times(f"gemm_dist {n}³", lambda x: par.gemm_dist("N", "N", 1.0, x, B,
                                                     0.5, C),
          lambda x: ct.gemm("N", "N", 1.0, x, B, 0.5, C),
          lambda x: torch.addmm(C, x, B, beta=0.5), A)

    S = call("dist syrk", lambda: par.syrk_dist("L", "N", -1.0, A, 1.0, C),
             only())
    require(torch.equal(torch.triu(S, 1), torch.triu(C, 1)),
            "syrk_dist: the strict upper changed")
    ref = torch.tril(C.double() - A.double() @ A.double().T)
    e_lib = max_err(torch.tril(torch.addmm(C, A, A.T, alpha=-1.0)), ref)
    err, lim, _ = gated(f"syrk_dist {n}", torch.tril(S), ref, e_lib)
    del S, ref
    print(f"syrk_dist L,N n=k={n} f32: max err vs f64 {err:.3e}, "
          f"torch.addmm's {e_lib:.3e} (limit {lim:.3e}), strict upper kept")
    times(f"syrk_dist n=k={n}", lambda x: par.syrk_dist("L", "N", -1.0, x,
                                                        1.0, C),
          lambda x: ct.syrk("L", "N", -1.0, x, 1.0, C),
          lambda x: torch.addmm(C, x, x.T, alpha=-1.0), A)
    del C

    # the triangular pair on a dense factor (cond 100: its own about 10)
    F, info = ct.potrf("L", dense_spd(gen, n))
    require(int(info) == 0, f"trsm_dist input factor: info {int(info)}")
    L = torch.tril(F)
    del F
    X = call("dist trsm", lambda: par.trsm_dist("L", "L", "N", "N", 1.0, L,
                                                B), exact("dist trsm"))
    L64, B64 = L.double(), B.double()
    ref = torch.linalg.solve_triangular(L64, B64, upper=False)
    e_lib = max_err(torch.linalg.solve_triangular(L, B, upper=False), ref)
    err, lim, rms = gated(f"trsm_dist {n}", X, ref, e_lib, rms=rms_of(ref))
    del X, ref
    print(f"trsm_dist L,L,N,N n=m={n} f32: max err vs f64 {err:.3e}, f32 "
          f"solve_triangular's {e_lib:.3e} (limit {lim:.3e}, 1/"
          f"{rms / lim:.0f} of the solution's RMS {rms:.3e})")
    times(f"trsm_dist n=m={n}", lambda x: par.trsm_dist("L", "L", "N", "N",
                                                        1.0, L, x),
          lambda x: ct.trsm("L", "L", "N", "N", 1.0, L, x),
          lambda x: torch.linalg.solve_triangular(L, x, upper=False), B)
    T = call("dist trmm", lambda: par.trmm_dist("L", "L", "N", "N", 1.0, A,
                                                B), only(trmm_lln_f32=1))
    At = torch.tril(A)
    ref = torch.tril(A.double()) @ B64
    e_lib = max_err(torch.matmul(At, B), ref)
    err, lim, _ = gated(f"trmm_dist {n}", T, ref, e_lib, rms=rms_of(ref))
    del T, ref, L64, B64
    print(f"trmm_dist L,L,N,N n=m={n} f32: max err vs f64 {err:.3e}, "
          f"torch.matmul(tril(A), B)'s {e_lib:.3e} (limit {lim:.3e})")
    times(f"trmm_dist n=m={n}", lambda x: par.trmm_dist("L", "L", "N", "N",
                                                        1.0, A, x),
          lambda x: ct.trmm("L", "L", "N", "N", 1.0, A, x),
          lambda x: torch.matmul(At, x), B)
    del A, B, At, L

    # f64 at 4096: the Ozaki kernels under every stripe product
    m = DBLAS_D_N
    A, B, C = (torch.randn(m, m, device="cuda", dtype=torch.float64,
                           generator=gen) for _ in range(3))
    L = torch.linalg.cholesky(dense_spd(gen, m).double())

    def rel64(what, got, ref):
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        require(rel <= m * 2.0 ** -40,
                f"{what}: max err / max|ref| {rel:.3e} > n·2^-40")
        return rel

    cases = (
        ("dist d gemm", "gemm_dist", lambda x: par.gemm_dist(
            "N", "N", 1.0, x, B, 0.5, C),
         lambda x: ct.gemm("N", "N", 1.0, x, B, 0.5, C),
         lambda x: torch.addmm(C, x, B, beta=0.5), A,
         lambda: A @ B + 0.5 * C),
        ("dist d trsm", "trsm_dist", lambda x: par.trsm_dist(
            "L", "L", "N", "N", 1.0, L, x),
         lambda x: ct.trsm("L", "L", "N", "N", 1.0, L, x),
         lambda x: torch.linalg.solve_triangular(L, x, upper=False), B,
         lambda: torch.linalg.solve_triangular(L, B, upper=False)),
        ("dist d trmm", "trmm_dist", lambda x: par.trmm_dist(
            "L", "L", "N", "N", 1.0, A, x),
         lambda x: ct.trmm("L", "L", "N", "N", 1.0, A, x),
         lambda x: torch.matmul(torch.tril(A), x), B,
         lambda: torch.tril(A) @ B))
    for path, name, dist_fn, ct_fn, lib_fn, x, ref_fn in cases:
        out = call(path, lambda: dist_fn(x), exact(path))
        rel = rel64(f"f64 {name} {m}", out, ref_fn())
        del out
        print(f"f64 {name} {m} (auto -> ozaki): max err / max|ref| "
              f"{rel:.3e} (bound n·2^-40 {m * 2.0 ** -40:.3e}) against "
              "cuBLAS/cuSOLVER f64")
        times(f"f64 {name} {m}", dist_fn, ct_fn, lib_fn, x)
    del A, B, C, L

    # c64 herk: a torch product a stripe (no kernel of the port), in c128
    Ac = torch.randn(m, m, dtype=torch.complex64, device="cuda",
                     generator=gen)
    Cc = torch.randn(m, m, dtype=torch.complex64, device="cuda",
                     generator=gen)
    H = call("dist herk", lambda: par.herk_dist("L", "N", 1.0, Ac, 0.5, Cc),
             only())
    require(torch.equal(torch.triu(H, 1), torch.triu(Cc, 1))
            and not bool(H.diagonal().imag.any()),
            "herk_dist: the strict upper changed or the diagonal is complex")
    A128 = Ac.to(torch.complex128)
    ref = torch.tril(A128 @ A128.mH + 0.5 * Cc.to(torch.complex128))
    ref.diagonal().imag.zero_()
    lib = torch.tril(torch.addmm(Cc, Ac, Ac.mH, beta=0.5))
    lib.diagonal().imag.zero_()
    e_lib = max_err(lib, ref)
    rms = float(ref.abs().square().sum().div(m * (m + 1) / 2).sqrt())
    err, lim, _ = gated(f"herk_dist {m}", torch.tril(H), ref, e_lib, rms=rms)
    del H, ref, lib, A128
    print(f"herk_dist L,N n=k={m} c64: max err vs c128 {err:.3e}, c64 "
          f"torch.addmm's {e_lib:.3e} (limit {lim:.3e}, 1/{rms / lim:.0f} "
          f"of the lower's RMS {rms:.3e}), strict upper kept, diagonal real")
    times(f"herk_dist n=k={m} c64", lambda x: par.herk_dist(
        "L", "N", 1.0, x, 0.5, Cc),
          lambda x: ct.herk("L", "N", 1.0, x, 0.5, Cc),
          lambda x: torch.addmm(Cc, x, x.mH, beta=0.5), Ac)
    print("dist BLAS times, ms (CUDA events, median of 3), the stripe call "
          "of one rank, the single-device ct call, one torch call, on "
          f"{name_power}:\n  " + "\n  ".join(lines))
    return runs


def dist_b_path(gen, name_power):
    """Phase 11: (a) the distributed GP step and (b) the distributed BLAS
    on a one-rank NCCL group, then (c) the dry run in a spawned NCCL rank
    of its own and entry()'s forward."""
    from cholesky_tpu_torch import entry
    t_phase = time.perf_counter()
    launch.init_single("cuda")
    try:
        runs = gp_dist_step_path(gen, name_power)
        runs.update(dist_blas_path(gen, name_power))
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    print(f"dryrun_multichip(1): {time.perf_counter() - t0:.1f} s, spawn "
          "included")
    if torch.cuda.device_count() < 2:
        try:
            entry.dryrun_multichip(2)
        except RuntimeError as e:
            print(f"dryrun_multichip(2) on {torch.cuda.device_count()} card "
                  f"raises: {e}")
        else:
            raise AssertionError("dryrun_multichip(2) ran on one card")
    fn, args = entry.entry()
    nll = float(fn(*args))
    require(math.isfinite(nll), f"entry(): non-finite nll {nll}")
    print(f"entry ok: gp_nll n=256 d=4 on the card: {nll:.4f}")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return runs


#: phase 12's sweep: the sizes of each letter, the counted one last
SWEEP_SIZES = {"s": (512, 1024), "d": (256, 512), "c": (256, 512),
               "z": (256, 512)}


def sweep_kernels(letter: str, op: str) -> tuple:
    """The kernels one point of the sweep launches at the counted size (s
    at 1024, d/c/z at 512), its fixture included (the triangular ops
    factor a latmc matrix first): the d and z points (z on the embedding
    of d) run the Ozaki products over the f32 leaves, s and c (on the
    embedding of s) the f32 kernels, and logdet_diag is a torch
    reduction."""
    if op == "logdet_diag":
        return ()
    products = ("peel_f64", "mm_groups_f64")
    if letter in "dz":
        if op in ("gemm", "gemm_k", "syrk"):
            return products
        return (*products, "potrf_block_f32", "trtri_block_f32")
    fixture = () if op in ("potrf", "logdet", "gemm", "gemm_k", "syrk") \
        else ("potrf_stream_f32",)
    # the embedding's herk and trmm are gemm_f32 products on live blocks
    own = {"potrf": ("potrf_stream_f32",), "logdet": ("potrf_stream_f32",),
           "potri": ("trtri_block_f32", "lauum_stream_f32"),
           "trtri": ("trtri_block_f32",), "lauum": ("lauum_stream_f32",),
           "gemm": ("gemm_f32",), "gemm_k": ("gemm_f32",),
           "syrk": ("syrk_lower_f32",) if letter == "s" else ("gemm_f32",),
           "trmm": ("trmm_lln_f32",) if letter == "s" else ("gemm_f32",),
           "trsm": ("trtri_block_f32", "gemm_f32")}[op]
    return (*fixture, *own)


def trace_potrf(n: int = 4096) -> dict:
    """Phase 12's trace, run in a process of its own: one potrf at n under
    profiling.trace inside an annotate span, and profiling.device_time of
    the same call. Returns what the trace file names and the census."""
    import glob
    import os
    import tempfile

    A = spd(torch.Generator(device="cuda").manual_seed(12), n)
    ct.potrf("L", A)
    with tempfile.TemporaryDirectory() as logdir:
        kernels.reset_launch_counts()
        with profiling.trace(logdir):
            with profiling.annotate("sweep-potrf"):
                _, info = ct.potrf("L", A)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        text = "".join(open(f).read() for f in files)
    return {"files": len(files), "bytes": len(text),
            "names_kernel": "potrf_stream_f32_kernel" in text,
            "names_span": "sweep-potrf" in text,
            "launches": kernels.launch_counts()["potrf_stream_f32"],
            "info": int(info),
            "device_time": profiling.device_time(lambda: ct.potrf("L", A),
                                                 "potrf_stream")}


def tooling_path(gen, name_power):
    """Phase 12: the tooling on the card. A profiling.trace of one potrf,
    the task pool beside gemm_f32, the sweep over all eleven ops in the
    four precisions with its launches by (letter, op), minibench's probes
    against the card's peaks and report --md over the golden files."""
    import io
    import os
    import subprocess
    import tempfile
    from pathlib import Path

    import numpy as np

    from cholesky_tpu_torch.runtime import TaskPool
    from cholesky_tpu_torch.tools import minibench, report, sweep

    t_phase = time.perf_counter()
    # (a) a trace of one potrf at 4096 inside a named span, in a fresh
    # process: in one that has kept the card busy for a minute or more,
    # torch.profiler on this machine often returns a short window without
    # its CUDA kernels (minibench's timer probe counts it below)
    child = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.trace_potrf()))"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    require(child.returncode == 0, f"the traced potrf failed:\n"
            f"{child.stderr[-3000:]}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"profiling.trace of potrf n=4096 in a fresh process: {got} on "
          f"{name_power}")
    require(got["files"] == 1 and got["names_kernel"] and got["names_span"]
            and got["launches"] == 1 and got["info"] == 0,
            "the trace misses the kernel or the span")
    census = got["device_time"]
    require(census.get("potrf_stream_f32_kernel", [0, 0])[1] == 1
            and census["busy"][1] == 1,
            "device_time: not one potrf_stream_f32 launch")

    # (b) four numpy f64 oracles on TaskPool(4) while gemm_f32 runs here
    rng = np.random.default_rng(12)
    G = rng.standard_normal((1024, 1024))
    S = G @ G.T / 1024 + np.eye(1024)
    jobs = [lambda: np.linalg.cholesky(S), lambda: np.linalg.inv(S),
            lambda: np.array(np.linalg.slogdet(S)), lambda: G @ S]
    serial = [job() for job in jobs]
    got = [None] * 4

    def task(i):
        def fn():
            got[i] = jobs[i]()
            return 0
        return fn

    X = torch.randn(4096, 4096, device="cuda", generator=gen)
    with TaskPool(4) as pool:
        tasks = [pool.run(i, task(i)) for i in range(4)]
        for _ in range(8):
            Y = gemm_f32(X, X)
        codes = [t.join() for t in tasks]
    same = [bool(np.array_equal(a, b)) for a, b in zip(got, serial)]
    err, lim, _ = gemm_gated("gemm_f32 beside the pool", Y, X, X)
    print(f"TaskPool(4): codes {codes}, equal to a serial run {same}; "
          f"gemm_f32 4096³ beside them: max err vs f64 {err:.3e} (limit "
          f"{lim:.3e})")
    require(codes == [0] * 4 and all(same), "TaskPool results differ")

    # (c) the sweep in-process, every launch counted by (letter, op, n)
    counted, real = {}, dict(sweep.POINTS)

    def counting(op, fn):
        def point(n, backend, dt, cfg):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = fn(n, backend, dt, cfg)
            torch.cuda.synchronize()
            counted[(dt.letter, op, n)] = {
                k: c for k, c in kernels.launch_counts().items() if c}
            return out
        return point

    ops = ",".join(sweep.POINTS)
    with tempfile.TemporaryDirectory() as tmp:
        sweep.POINTS.update({op: counting(op, fn) for op, fn in real.items()})
        try:
            for letter, sizes in SWEEP_SIZES.items():
                out = os.path.join(tmp, f"{letter}.jsonl")
                with contextlib.redirect_stdout(io.StringIO()):  # the rows
                    rc = sweep.main(["--dtype", letter, "--ops", ops,
                                     "--sizes", ",".join(map(str, sizes)),
                                     "--out", out, "--max-chain", "5"])
                rows = sweep.load_rows(out)
                bad = [r for r in rows if not r["passed"]
                       or r.get("card") != name_power]
                print(f"sweep {letter}: rc {rc}, {len(rows)} rows, "
                      f"{len(rows) - len(bad)} passed on {name_power}")
                for r in bad:
                    print(f"  FAILED {r}")
                require(rc == 0 and not bad
                        and len(rows) == len(sizes) * len(real),
                        f"sweep {letter}: a row failed")
        finally:
            sweep.POINTS.update(real)
    for letter, sizes in SWEEP_SIZES.items():
        for op in real:
            launches = counted[(letter, op, sizes[-1])]
            want = sweep_kernels(letter, op)
            print(f"  sweep {letter} {op} n={sizes[-1]}: "
                  + (", ".join(f"{k} {c}" for k, c in launches.items())
                     or "no kernel (torch)"))
            require(set(want) <= set(launches),
                    f"sweep {letter} {op}: expected {want}, launched "
                    f"{launches}")

    # (d) minibench against the card's peaks
    mb = minibench.run()
    print(f"minibench: {json.dumps(mb)}")
    f32, hbm = mb["matmul"]["f32_tflops"], mb["hbm"]["stream_gbps"]
    require(0 < f32 <= PEAK_OPS["f32"] / 1e12,
            f"minibench f32 matmul {f32} TF/s outside (0, 67]")
    require(hbm <= HBM_BYTES_PER_S / 1e9,
            f"minibench HBM {hbm} GB/s above 3350")
    require(mb["timer"]["block_is_trustworthy"],
            "torch.cuda.synchronize() did not wait for the card")

    # (e) report --md over the committed golden files
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_results")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", here, "--md"])
    table = buf.getvalue()
    print(table, end="")
    pairs = {(letter, r["op"]) for letter in "sdcz"
             for r in report.load(Path(here) / report.GOLDEN.format(letter))
             if "gflops" in r}
    body = [ln for ln in table.splitlines() if ln.startswith("| ")
            and not ln.startswith("| dtype")]
    require(pairs and len(body) == len(pairs),
            f"report --md: {len(body)} rows for {len(pairs)} (dtype, op)")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


#: each path's kernels: the launch counters must show every one of them
PATHS = {
    "potrf": ("potrf_stream_f32",),
    "potrf block_size=512": ("gemm_f32", "syrk_lower_f32", "potrf_stream_f32",
                             "trtri_block_f32"),
    "GP": ("gemm_f32", "trtri_block_f32", "potrf_stream_f32",
           "trtri_stream_f32", "lauum_stream_f32", "rbf_f32",
           "rbf_grad_f32"),
    "potri": ("trtri_stream_f32", "lauum_stream_f32"),
    "lauum block_size=512": ("gemm_f32", "syrk_lower_f32", "lauu2_f32"),
    "Ozaki pair": ("peel_f32pair", "mm_groups_f32pair"),
    "d": ("peel_f64", "mm_groups_f64", "potrf_block_f32",
          "trtri_block_f32"),
    "strmm": ("trmm_lln_f32",),
    "sgemm": ("gemm_f32",),
    "ssyrk": ("syrk_lower_f32",),
    "dtrmm": ("peel_f64", "mm_groups_f64"),
    "spotf2": ("potf2_f32",),
    "strtri n=8320 block_size=8320": ("trti2_f32",),
    "lauum block_size=2048": ("lauu2_f32",),
    "z": ("peel_f64", "mm_groups_f64", "potrf_block_f32",
          "trtri_block_f32"),
    "ztrsm": ("uniform_fill_f64", "peel_f64", "mm_groups_f64",
              "trtri_block_f32"),
    "cpotrf": ("potrf_stream_f32",),
    "ctrsm": ("uniform_fill_f32", "trtri_block_f32", "gemm_f32"),
    "cgemm": ("gemm_f32",),
    "cherk": ("gemm_f32",),
    "ctrmm": ("gemm_f32",),
    "dist potrf": ("potrf_block_f32", "trtri_block_f32", "gemm_f32"),
    "dist logdet": ("potrf_block_f32", "trtri_block_f32", "gemm_f32"),
    "dist trsm N": (),
    "dist trsm T": (),
    "dist potri": ("trtri_block_f32", "gemm_f32"),
    "dist d": ("peel_f64", "mm_groups_f64", "potrf_block_f32",
               "trtri_block_f32"),
    "dist GP": ("potrf_block_f32", "trtri_block_f32", "gemm_f32"),
    "dist gemm": (),
    "dist syrk": (),
    "dist trsm": ("trtri_block_f32", "gemm_f32"),
    "dist trmm": ("trmm_lln_f32",),
    "dist d gemm": ("peel_f64", "mm_groups_f64"),
    "dist d trsm": ("peel_f64", "mm_groups_f64", "trtri_block_f32"),
    "dist d trmm": ("peel_f64", "mm_groups_f64"),
    "dist herk": (),
}

#: each kernel: its source, the TPU kernel it replaces, and the path whose
#: run gives its launch count in the kernels line
SOURCES = {
    "gemm_f32": ("cholesky_tpu_torch/ops/kernels/csrc/gemm.cu",
                 "cholesky_tpu/ops/pallas/gemm.py:64", "GP"),
    "syrk_lower_f32": ("cholesky_tpu_torch/ops/kernels/csrc/syrk.cu",
                       "cholesky_tpu/ops/pallas/syrk.py:70",
                       "potrf block_size=512"),
    "potrf_block_f32": ("cholesky_tpu_torch/ops/kernels/csrc/potrf_block.cu",
                        "cholesky_tpu/ops/pallas/mega.py:234", "d"),
    "potrf_stream_f32": ("cholesky_tpu_torch/ops/kernels/csrc/"
                         "potrf_stream.cu",
                         "cholesky_tpu/ops/pallas/mega.py:364", "GP"),
    "trtri_block_f32": ("cholesky_tpu_torch/ops/kernels/csrc/trtri_block.cu",
                        "cholesky_tpu/ops/pallas/mega.py:519", "GP"),
    "trtri_stream_f32": ("cholesky_tpu_torch/ops/kernels/csrc/trtri_stream.cu",
                         "cholesky_tpu/ops/pallas/mega.py:656", "GP"),
    "lauum_stream_f32": ("cholesky_tpu_torch/ops/kernels/csrc/lauum.cu",
                         "cholesky_tpu/ops/pallas/mega.py:444", "GP"),
    "lauu2_f32": ("cholesky_tpu_torch/ops/kernels/csrc/lauum.cu",
                  "cholesky_tpu/ops/pallas/leaf.py:297",
                  "lauum block_size=512"),
    "peel_f32pair": ("cholesky_tpu_torch/ops/kernels/csrc/ozaki_peel.cu",
                     "cholesky_tpu/ops/pallas/ozaki_split.py:57",
                     "Ozaki pair"),
    "mm_groups_f32pair": ("cholesky_tpu_torch/ops/kernels/csrc/ozaki_mm.cu",
                          "cholesky_tpu/ops/pallas/ozaki_mm.py:105",
                          "Ozaki pair"),
    "peel_f64": ("cholesky_tpu_torch/ops/kernels/csrc/ozaki_peel.cu",
                 "none: XLA's fusion of cholesky_tpu/ops/ozaki.py:63-72 "
                 "before ozaki_split.py:57", "d"),
    "mm_groups_f64": ("cholesky_tpu_torch/ops/kernels/csrc/ozaki_mm.cu",
                      "none: XLA's fusion of cholesky_tpu/ops/ozaki.py:"
                      "158-159 after ozaki_mm.py:105", "d"),
    "potf2_f32": ("cholesky_tpu_torch/ops/kernels/csrc/leaf.cu",
                  "cholesky_tpu/ops/pallas/leaf.py:146", "spotf2"),
    "trti2_f32": ("cholesky_tpu_torch/ops/kernels/csrc/leaf.cu",
                  "cholesky_tpu/ops/pallas/leaf.py:263",
                  "strtri n=8320 block_size=8320"),
    "trmm_lln_f32": ("cholesky_tpu_torch/ops/kernels/csrc/trmm.cu",
                     "cholesky_tpu/ops/pallas/trmm.py:66", "strmm"),
    "uniform_fill_f32": ("cholesky_tpu_torch/ops/kernels/csrc/prng.cu",
                         "cholesky_tpu/rng/pallas_prng.py:60", "ctrsm"),
    "uniform_fill_f64": ("cholesky_tpu_torch/ops/kernels/csrc/prng.cu",
                         "cholesky_tpu/rng/pallas_prng.py:106", "ztrsm"),
    "rbf_f32": ("cholesky_tpu_torch/ops/kernels/csrc/rbf.cu",
                "none: XLA's fusion of cholesky_tpu/models/gp.py:45-60",
                "GP"),
    "rbf_grad_f32": ("cholesky_tpu_torch/ops/kernels/csrc/rbf.cu",
                     "none: XLA's fusion of cholesky_tpu/models/gp.py:90-103",
                     "GP"),
}


def trtri_kernels(n: int, nb: int) -> tuple:
    """The kernels a trtri working copy of n launches on the card with
    leaves of nb, as ``blocked._trtri_lower`` routes it under the tuning
    table in force: one whole-matrix kernel where ``_mega_ok`` takes the
    block, trti2_f32 for a leaf it refuses, else the halves and two
    gemm_f32 products."""
    if blocked._mega_ok(n, "trtri"):
        return ("trtri_block_f32" if n <= mega.MAX_N else
                "trtri_stream_f32",)
    if n <= nb:
        return ("trti2_f32",)
    n1 = blocked._split(n, nb)
    return tuple(dict.fromkeys(("gemm_f32", *trtri_kernels(n1, nb),
                                *trtri_kernels(n - n1, nb))))


def routed_paths() -> dict:
    """The paths whose kernels the tuning table in force decides:
    ``strtri(block_size=8192)`` at 8192, ``potri`` at 6000 (its working
    copy padded to 6144) and ``cpotri`` at 4096 (8192 embedded)."""
    nb = blocked._KernelTiles().default_nb
    return {
        "strtri block_size=8192": trtri_kernels(B_N, B_N),
        "potri n=6000": (*trtri_kernels(6144, nb), "lauum_stream_f32"),
        "cpotri": (*trtri_kernels(2 * CZ_N, nb), "lauum_stream_f32"),
    }


def short_name(mangled: str) -> str:
    """The last name of an Itanium-mangled symbol, its template arguments
    as mangled (``potf2_update128<Lb1>``), for ptxas' log."""
    s, names = mangled.removeprefix("_ZN").removeprefix("_Z"), []
    while s[:1].isdigit():
        digits = len(s) - len(s.lstrip("0123456789"))
        size = int(s[:digits])
        names.append(s[digits:digits + size])
        s = s[digits + size:]
    if not names:
        return mangled
    args = s[1:s.find("EE") + 1].replace("E", "") if s[:1] == "I" else ""
    return names[-1] + (f"<{args}>" if args else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # 1. device and environment
    name_power = card()
    print(name_power)           # exactly as nvidia-smi gives it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"TF32: matmul {tf32[0]}, cudnn {tf32[1]}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()}")
    require(tf32 == (False, False), "TF32 must be off")
    print(f"tuning table: {bench_torch.table_in_force()}; in force: "
          + "; ".join(f"{op} {get_params(op)}" for op in DEFAULTS))
    routed = routed_paths()
    PATHS.update(routed)
    for name, ks in routed.items():
        print(f"  path {name!r} under the table: {', '.join(ks)}")

    # 2. build
    b = _build.build()
    print(f"build: nvcc {b.seconds:.1f} s -> {b.path} (on the host of "
          f"{name_power})")
    fn = ""
    for line in b.log.read_text().splitlines():
        text = line.strip().removeprefix("ptxas info    : ")
        if "Function properties for" in line:
            fn = short_name(line.split()[-1])
        elif text.startswith("Used ") or "bytes spill" in text:
            print(f"  ptxas: {fn}: {text}")   # the function's own counts
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {text}")

    # 3. kernels against their twins
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    check_gemm(gen, rec, name_power)
    check_syrk(gen, rec, name_power)
    check_potrf_block(gen, rec, name_power)
    check_potrf_stream(gen, rec, name_power)
    check_trtri_block(gen, rec, name_power)
    check_trtri_stream(gen, rec, name_power)
    check_lauum_stream(gen, rec, name_power)
    check_lauu2(gen, rec, name_power)
    check_peel(gen, rec, name_power)
    check_mm_groups(gen, rec, name_power)
    check_potf2(gen, rec, name_power)
    check_trti2(gen, rec, name_power)
    check_trmm(gen, rec, name_power)
    check_prng(rec, name_power)
    check_rbf(gen, rec, name_power)

    # 4. the potrf path
    runs = main_path(gen, name_power)

    # 5. the GP model, potri, lauum on leaves
    runs.update(gp_path(name_power))

    # 6. the d tier
    runs.update(d_path(gen, name_power))

    # 7. the BLAS path and the leaf routes
    runs.update(blas_path(gen, name_power))

    # 8. the c/z tier through the real embedding
    runs.update(cz_path(gen, name_power))

    # 9. the headline bench, bench_torch.py's ladder
    t_phase = time.perf_counter()
    line = bench_torch.run(log=print)
    print(f"bench_torch.py headline: {json.dumps(line)} on {name_power} "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # 10. the block-cyclic tier on one NCCL rank
    runs.update(dist_path(gen, name_power))

    # 11. the distributed GP step, the distributed BLAS and the dry run
    runs.update(dist_b_path(gen, name_power))

    # 12. the tooling: profiling, the task pool, sweep, minibench, report
    tooling_path(gen, name_power)
    require("jax" not in sys.modules, "jax was imported")
    require(set(SOURCES) == set(kernels.KERNELS),
            "a kernel is missing from the kernels line")

    # each kernel's launches from the run of the path it serves
    rows = [dict(name=k, route="cuda", source=src, replaces=tpu, path=path,
                 launches=runs[path][k], **rec[k],
                 launches_by_path={p: c[k] for p, c in runs.items() if c[k]})
            for k, (src, tpu, path) in SOURCES.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
