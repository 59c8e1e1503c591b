"""Whole-matrix kernels, each beside its plain torch twin:

- potrf_block_f32 (csrc/potrf_block.cu) and trtri_block_f32
  (csrc/trtri_block.cu) replace ``cholesky_tpu/ops/pallas/mega.py:
  potrf_vmem_f32`` and ``trtri_vmem_f32`` and keep their limits: a block of
  n <= MAX_N, and the blocked recursion hands them n <= NB or a multiple
  of NB;
- potrf_stream_f32 (csrc/potrf_stream.cu), trtri_stream_f32
  (csrc/trtri_stream.cu) and lauum_stream_f32 (csrc/lauum.cu) replace
  ``potrf_hbm_f32``, ``trtri_hbm_f32`` and ``lauum_hbm_f32``: any multiple
  of NB up to STREAM_MAX_N.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.ops.kernels.syrk import WAVE
from cholesky_tpu_torch.utils.errors import check

NB = 128            # the blocked recursion's granularity for these kernels
MAX_N = 1024        # one thread block holds a 32-wide panel of this height
#: from this n potrf_block_f32 runs as one cooperative launch over many
#: thread blocks, below it on one (the A/B of chip_smoke.py's phase 3)
POTRF_BLOCK_MULTI_MIN_N = 256
STREAM_MAX_N = 8192  # the JAX package's {POTRF,TRTRI,LAUUM}_HBM_MAX_N
#: from this n a multiple of NB is factored by potrf_stream_f32 rather than
#: by potrf_block_f32 (the A/B of chip_smoke.py's phase 3: even at 256 and
#: 512, the stream kernel 6-9 % ahead at 768 and 1024)
POTRF_STREAM_MIN_N = 512


def _check_block(A, name, max_n=MAX_N, multiple=1):
    # the common case first, with no message built: this runs on every call
    if (A.ndim == 2 and A.dtype == torch.float32 and A.stride(1) == 1
            and 1 <= (n := A.shape[0]) <= max_n and A.shape[1] == n
            and n % multiple == 0 and A.stride(0) >= n
            and A.device.type in ("cpu", "cuda")):
        return n
    check(A.ndim == 2 and A.shape[0] == A.shape[1], name, 1,
          f"expected a square block, got {tuple(A.shape)}")
    n = A.shape[0]
    check(A.dtype == torch.float32, name, 1, "float32 only")
    check(1 <= n <= max_n and n % multiple == 0, name, 1,
          f"n={n} outside 1..{max_n}" +
          (f" or not a multiple of {multiple}" if multiple > 1 else ""))
    check(A.stride(1) == 1 and A.stride(0) >= n, name, 1,
          "rows must be unit-stride (a row-major block or a slice of one)")
    check(A.device.type in ("cpu", "cuda"), name, 1,
          f"unsupported device {A.device}")
    return n


def potrf_block_plain(A):
    """The plain torch version, any real dtype and device: factors the
    lower triangle of A in place, zeroes the strict upper, returns info."""
    F, info = lapack_ref.potf2("L", A)
    A.copy_(torch.tril(F))
    return info


#: trtri_block_f32's leaf tile: the diagonal tiles it inverts first, each
#: on one thread block (csrc/trtri_block.cu, LW)
TRTRI_LEAF = 128


def trtri_levels(n):
    """trtri_block_f32's order of work after the leaves: for s =
    TRTRI_LEAF, 2·TRTRI_LEAF, ... < n, the pairs (a0, c0, sc) of inverted
    s-blocks it joins (A at rows a0:a0+s, C at c0 = a0 + s, sc rows, the
    last one short)."""
    levels = []
    s = TRTRI_LEAF
    while s < n:
        levels.append((s, [(a0, a0 + s, min(s, n - a0 - s))
                           for a0 in range(0, n - s, 2 * s)]))
        s *= 2
    return levels


def trtri_block_plain(L):
    """The plain torch version, any dtype and device, in the kernel's order
    of work: each TRTRI_LEAF diagonal tile inverted (the oracle's trti2,
    a zero diagonal read as 1), then for each level of
    :func:`trtri_levels` W21 = −C⁻¹·(B·A⁻¹). Returns (inverse of tril(L)
    with the strict upper zero, info), info the first zero diagonal."""
    n = L.shape[0]
    T = torch.tril(L)
    W = torch.zeros_like(T)
    for r0 in range(0, n, TRTRI_LEAF):
        r1 = min(r0 + TRTRI_LEAF, n)
        W[r0:r1, r0:r1] = torch.tril(
            lapack_ref.trti2("L", "N", T[r0:r1, r0:r1])[0])
    for s, pairs in trtri_levels(n):
        for a0, c0, sc in pairs:
            X = T[c0:c0 + sc, a0:c0] @ W[a0:c0, a0:c0]
            W[c0:c0 + sc, a0:c0] = -(W[c0:c0 + sc, c0:c0 + sc] @ X)
    zero = torch.diagonal(L) == 0
    info = torch.where(zero.any(), zero.int().argmax() + 1, 0).to(torch.int32)
    return W, info


@_build.kernel_span("potrf_block_f32")
def potrf_block_f32(A):
    """Lower Cholesky of the f32 block A (n <= MAX_N, unit-stride rows), in
    place: only the lower triangle is read, the strict upper is zeroed.
    Returns info, a 0-d int32 tensor on A's device: the 1-based index of
    the first pivot with !(d > 0) (NaN-safe), 0 on success. The factor
    freezes at a failed pivot and every stored value stays finite, except
    an input NaN at its own position. On the card it runs on one thread
    block below POTRF_BLOCK_MULTI_MIN_N, else as one cooperative launch
    over many."""
    n = _check_block(A, "potrf_block_f32")
    if A.device.type == "cpu":
        return potrf_block_plain(A)
    multi = n >= POTRF_BLOCK_MULTI_MIN_N
    info = torch.empty((), dtype=torch.int32, device=A.device)
    _build.launch(
        "potrf_block_f32", A.data_ptr(), A.stride(0), n, info.data_ptr(),
        int(multi), *_build.device_args(A))
    potrf_block_f32.launches += 1
    return info


@_build.kernel_span("trtri_block_f32")
def trtri_block_f32(L):
    """Inverse of the lower-triangular f32 block L (n <= MAX_N,
    unit-stride rows); only its lower triangle is read. Returns (W, info):
    W a new contiguous tensor with a zero strict upper, info (0-d int32)
    the 1-based index of the first zero diagonal, which is treated as 1
    and does not stop the inversion. The launch also takes n² floats of
    scratch on the card, freed on return."""
    n = _check_block(L, "trtri_block_f32")
    if L.device.type == "cpu":
        return trtri_block_plain(L)
    W = torch.empty((n, n), dtype=L.dtype, device=L.device)
    S = torch.empty((n, n), dtype=L.dtype, device=L.device)   # B·A⁻¹
    info = torch.empty((), dtype=torch.int32, device=L.device)
    _build.launch(
        "trtri_block_f32", L.data_ptr(), L.stride(0), W.data_ptr(),
        W.stride(0), S.data_ptr(), n, info.data_ptr(),
        *_build.device_args(L))
    trtri_block_f32.launches += 1
    return W, info


def potrf_stream_plain(A):
    """The plain torch version, any real dtype and device: the kernel's
    right-looking walk over NB-wide panels, in place (each diagonal tile by
    the oracle's potf2, the panel below it by a triangular solve, the
    trailing matrix by a product); the strict upper is zeroed. Returns
    info. A tile with a failed pivot is stored as potf2 leaves it, and
    nothing after it is solved or updated."""
    n = A.shape[0]
    info = torch.zeros((), dtype=torch.int32, device=A.device)
    for c0 in range(0, n, NB):
        c1 = min(c0 + NB, n)
        F, i = lapack_ref.potf2("L", A[c0:c1, c0:c1])
        A[c0:c1, c0:c1] = torch.tril(F)
        if int(i):
            info = (i + c0).to(torch.int32)
            break
        # X·L11ᵀ = A21, then A22 -= X·Xᵀ (the strict upper is zeroed below)
        X = torch.linalg.solve_triangular(A[c0:c1, c0:c1].T, A[c1:, c0:c1],
                                          upper=True, left=False)
        A[c1:, c0:c1] = X
        A[c1:, c1:] -= X @ X.T
    A.copy_(torch.tril(A))
    return info


#: stamps per row of potrf_stream_f32's trace (csrc/potrf_stream.cu, enum
#: Stamp): row 0 is the launch's first phase, row 1 + j panel j
STREAM_TRACE_SLOTS = 8


@_build.kernel_span("potrf_stream_f32")
def potrf_stream_f32(A, *, trace=None):
    """Lower Cholesky of the f32 matrix A, n a multiple of NB up to
    STREAM_MAX_N, unit-stride rows, in place, as :func:`potrf_block_f32`
    does: only the lower triangle is read, the strict upper is zeroed, and
    info (0-d int32) is the first pivot with !(d > 0), the factor frozen
    there. The launch also takes (2n + NB)·NB floats of scratch on the
    card, freed on return. ``trace``, for measurement on the card only: a
    zeroed int64 tensor of (n / NB, STREAM_TRACE_SLOTS) into which the
    launch writes the card's nanosecond clock at each phase boundary."""
    n = _check_block(A, "potrf_stream_f32", STREAM_MAX_N, NB)
    if trace is not None:
        check(A.device.type == "cuda" and trace.device == A.device
              and trace.dtype == torch.int64 and trace.is_contiguous()
              and trace.shape == (n // NB, STREAM_TRACE_SLOTS),
              "potrf_stream_f32", 2, "trace must be a contiguous int64 "
              f"({n // NB}, {STREAM_TRACE_SLOTS}) tensor beside A on the card")
    if A.device.type == "cpu":
        return potrf_stream_plain(A)
    # the solved panel rows, the tile inverse below them, and the rows
    # transposed
    P = torch.empty((2 * n + NB, NB), dtype=A.dtype, device=A.device)
    info = torch.empty((), dtype=torch.int32, device=A.device)
    _build.launch(
        "potrf_stream_f32", A.data_ptr(), A.stride(0), P.data_ptr(),
        P[n:].data_ptr(), P[n + NB:].data_ptr(), n, info.data_ptr(),
        trace.data_ptr() if trace is not None else None,
        *_build.device_args(A))
    potrf_stream_f32.launches += 1
    return info


def trtri_stream_plain(L):
    """The plain torch version, any real dtype and device, in the kernel's
    order of work: :func:`trtri_block_plain` (the TRTRI_LEAF leaves, then
    the levels of :func:`trtri_levels`). Returns (inverse of tril(L) with
    the strict upper zero, info), info the first zero diagonal."""
    return trtri_block_plain(L)


#: stamps per phase of trtri_stream_f32's trace (csrc/trtri_stream.cu): block
#: 0's entry into the phase, the last end of any block's work in it
TRTRI_TRACE_SLOTS = 2
#: from this many NB-tiles a launch of lauum_stream_f32, or a product of a
#: trtri_stream_f32 level, takes a block a tile, the deepest first; below it
#: the tiles' k-steps are cut in equal runs for one WAVE of blocks
#: (chip_smoke.py's A/B)
STREAM_WHOLE_MIN_TILES = WAVE


def trtri_stream_plan(n):
    """trtri_stream_f32's levels at n: [(s, whole)], whole when each of the
    level's two products has STREAM_WHOLE_MIN_TILES NB-tiles or more."""
    return [(s, sum(s // NB * (sc // NB) for _, _, sc in pairs)
             >= STREAM_WHOLE_MIN_TILES) for s, pairs in trtri_levels(n)]


def trtri_stream_phases(n):
    """The phases of trtri_stream_f32 at n in launch order, one row of its
    trace each: the leaves; for each level s, the product T = B·A⁻¹ (kept
    transposed), then W21 = −C⁻¹·T, each followed by the sum of its split
    tiles where the level is cut in runs; the finish."""
    names = ["leaves"]
    for s, whole in trtri_stream_plan(n):
        names += ([f"level {s} T", f"level {s} W"] if whole else
                  [f"level {s} T", f"level {s} T sum", f"level {s} W",
                   f"level {s} W sum"])
    return names + ["finish"]


@_build.kernel_span("trtri_stream_f32")
def trtri_stream_f32(L, *, trace=None):
    """Inverse of the lower-triangular f32 matrix L, n a multiple of NB up
    to STREAM_MAX_N, unit-stride rows; only its lower triangle is read.
    Returns (W, info) as :func:`trtri_block_f32` does: W a new contiguous
    tensor with a zero strict upper, info (0-d int32) the 1-based index of
    the first zero diagonal, which is treated as 1. The launch also takes
    two NB x NB tiles of scratch a block, 2·WAVE·NB² floats, on the card,
    freed on return. ``trace``, for measurement on the card only: a zeroed
    int64 tensor of (len(trtri_stream_phases(n)), TRTRI_TRACE_SLOTS) into
    which the launch writes the card's nanosecond clock at each phase
    boundary."""
    n = _check_block(L, "trtri_stream_f32", STREAM_MAX_N, NB)
    if trace is not None:
        rows = len(trtri_stream_phases(n))
        check(L.device.type == "cuda" and trace.device == L.device
              and trace.dtype == torch.int64 and trace.is_contiguous()
              and trace.shape == (rows, TRTRI_TRACE_SLOTS),
              "trtri_stream_f32", 2, "trace must be a contiguous int64 "
              f"({rows}, {TRTRI_TRACE_SLOTS}) tensor beside L on the card")
    if L.device.type == "cpu":
        return trtri_stream_plain(L)
    W = torch.empty((n, n), dtype=L.dtype, device=L.device)
    # each run's two partial tiles
    P = torch.empty((2 * WAVE * NB * NB,), dtype=L.dtype, device=L.device)
    info = torch.empty((), dtype=torch.int32, device=L.device)
    _build.launch(
        "trtri_stream_f32", L.data_ptr(), L.stride(0), W.data_ptr(),
        W.stride(0), P.data_ptr(), n, WAVE, STREAM_WHOLE_MIN_TILES,
        info.data_ptr(), trace.data_ptr() if trace is not None else None,
        *_build.device_args(L))
    trtri_stream_f32.launches += 1
    return W, info


def lauum_stream_plain(L):
    """The plain torch version, any real dtype and device: tril(LᵀL) from
    the lower triangle of L, a new tensor with a zero strict upper."""
    T = torch.tril(L)
    return torch.tril(T.T @ T)


#: k-steps of the 128 tile (csrc/runs128.cuh)
RUN_STEP = 16


def lauum_tiles(n):
    """The lower NB-tiles of lauum_stream_f32 (and of lauu2_f32, at any n:
    the last row and column block partial) at n in the kernel's order, row
    by row over the triangle, each with its k-steps: ((I, J), steps), tile
    (I, J) summing over L's rows [NB·I, n) in steps of RUN_STEP, the last
    one short where n − NB·I is not a multiple of RUN_STEP."""
    nt = -(-n // NB)
    return [((i, j), -(-(n - NB * i) // RUN_STEP))
            for i in range(nt) for j in range(i + 1)]


def lauum_launch_plan(n, *, blocks=None, whole=False):
    """(q, blocks) of lauum_stream_f32 at n, and of lauu2_f32 at any n:
    from STREAM_WHOLE_MIN_TILES
    tiles (or with ``whole``) q = 0, a block a tile in :func:`lauum_tiles`'
    order, which is the deepest first; below it (or given ``blocks``) the
    lower tiles' k-steps in that order cut in equal runs of q, one a block,
    for one WAVE of blocks (or ``blocks``). The overrides are the A/B of
    chip_smoke.py."""
    nt = -(-n // NB)
    tiles = nt * (nt + 1) // 2
    if whole or (blocks is None and tiles >= STREAM_WHOLE_MIN_TILES):
        return 0, tiles
    # row i's i + 1 tiles of 8·(nt − i) − f steps (f the steps a partial
    # last row block lacks), in closed form, without listing the tiles:
    # this runs on every call
    f = (NB * nt - n) // RUN_STEP
    total = (NB // RUN_STEP) * nt * (nt + 1) * (nt + 2) // 6 \
        - f * nt * (nt + 1) // 2
    q = -(-total // (blocks or WAVE))
    return q, -(-total // q)


def lauum_runs(n, q):
    """The runs of a plan of q steps: for each block, its parts ((I, J),
    s0, s1), steps [s0, s1) of tile (I, J), in order. A part that is not a
    whole tile goes to the block's scratch and is summed with the tile's
    other parts in run order, which is k order."""
    runs, u = [], 0
    for tile, steps in lauum_tiles(n):
        s = 0
        while s < steps:
            b = u // q
            take = min(steps - s, (b + 1) * q - u)
            runs += [[] for _ in range(b + 1 - len(runs))]
            runs[b].append((tile, s, s + take))
            s += take
            u += take
    return runs


@_build.kernel_span("lauum_stream_f32")
def lauum_stream_f32(L):
    """tril(LᵀL) for the f32 matrix L, n a multiple of NB up to
    STREAM_MAX_N, unit-stride rows; only the lower triangle of L is read.
    Out of place: returns a new contiguous tensor (n² floats beside the
    input) with a zero strict upper. The launch also takes n·NB floats of
    scratch (L's diagonal tiles) and, when its runs split tiles, two NB x
    NB tiles a block (2·WAVE·NB² floats) on the card, freed on return."""
    n = _check_block(L, "lauum_stream_f32", STREAM_MAX_N, NB)
    if L.device.type == "cpu":
        return lauum_stream_plain(L)
    q, blocks = lauum_launch_plan(n)
    B = torch.empty((n, n), dtype=L.dtype, device=L.device)
    D = torch.empty((n, NB), dtype=L.dtype, device=L.device)
    # where runs split tiles, two partial tiles a block
    P = (torch.empty((2 * blocks * NB * NB,), dtype=L.dtype,
                     device=L.device) if q else None)
    _build.launch(
        "lauum_stream_f32", L.data_ptr(), L.stride(0), B.data_ptr(),
        B.stride(0), n, q, blocks, D.data_ptr(), P.data_ptr() if q else None,
        *_build.device_args(L))
    lauum_stream_f32.launches += 1
    return B


potrf_block_f32.launches = 0
potrf_stream_f32.launches = 0
trtri_block_f32.launches = 0
trtri_stream_f32.launches = 0
lauum_stream_f32.launches = 0
