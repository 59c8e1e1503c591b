"""The leaf kernels, each beside its plain torch twin:

- potf2_f32 and trti2_f32 (csrc/leaf.cu) replace
  ``cholesky_tpu/ops/pallas/leaf.py:potf2_f32`` and ``trti2_f32``: the
  Cholesky and the lower inverse of a block of n <= NB or a multiple of NB,
  with no upper cap. They take the blocks the whole-matrix kernels refuse
  (ops/blocked.py ``_KernelTiles``) and the public potf2 above them;
- lauu2_f32 (csrc/lauum.cu) replaces ``leaf.py:lauu2_f32``, the leaf of the
  lauum recursion: lauum_stream_f32's kernel and plan at any n. The strict
  upper of the result is the input's, bit for bit, as in LAPACK's xlauu2.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.ops.kernels import _build, mega
from cholesky_tpu_torch.ops.kernels.gemm import GEMM128_MIN_TILES
from cholesky_tpu_torch.ops.kernels.mega import (NB, _check_block,
                                                 trtri_block_plain)
from cholesky_tpu_torch.ops.kernels.syrk import WAVE
from cholesky_tpu_torch.utils.errors import check


#: the leaf kernels take any n a 32-bit index reaches
LEAF_MAX_N = 2 ** 31 - 1


def _check_leaf(A, name):
    n = _check_block(A, name, max_n=LEAF_MAX_N)
    check(n <= NB or n % NB == 0, name, 1,
          f"n={n} must be <= {NB} or a multiple of {NB}")
    return n


#: potf2_f32's strip width: the panels of a strip update only its own
#: columns, and the trailing matrix takes one product of this depth a strip
POTF2_KB = 512


def potf2_strips(n, kb=None):
    """potf2_f32's outer walk: the strips [j0, j1) of kb columns (default
    POTF2_KB)."""
    kb = kb or POTF2_KB
    return [(j0, min(j0 + kb, n)) for j0 in range(0, n, kb)]


def potf2_plain(A):
    """The plain torch version, any real dtype and device, in the kernel's
    order of work, in place, the strict upper zeroed; returns info. For
    each strip of :func:`potf2_strips`, NB-wide panels right-looking
    inside the strip (each diagonal tile by the oracle's potf2, the rows
    below it by a triangular solve, the strip's own columns by a product),
    then the trailing matrix by one product of the strip's depth. Past a
    failed pivot nothing is solved or updated."""
    n = A.shape[0]
    info = torch.zeros((), dtype=torch.int32, device=A.device)
    for j0, j1 in potf2_strips(n):
        for c0 in range(j0, j1, NB):
            c1 = min(c0 + NB, n)
            F, i = lapack_ref.potf2("L", A[c0:c1, c0:c1])
            A[c0:c1, c0:c1] = torch.tril(F)
            if int(i):
                A.copy_(torch.tril(A))
                return (i + c0).to(torch.int32)
            X = torch.linalg.solve_triangular(
                A[c0:c1, c0:c1].T, A[c1:, c0:c1], upper=True, left=False)
            A[c1:, c0:c1] = X
            A[c1:, c1:j1] -= X @ X[:j1 - c1].T
        P = A[j1:, j0:j1]
        A[j1:, j1:] -= P @ P.T
    A.copy_(torch.tril(A))
    return info


@_build.kernel_span("potf2_f32")
def potf2_f32(A):
    """Lower Cholesky of the f32 block A (n <= NB or a multiple of NB, no
    cap; unit-stride rows), in place: only the lower triangle is read, the
    strict upper is zeroed. Returns info, a 0-d int32 tensor on A's
    device: the 1-based index of the first pivot with !(d > 0)
    (NaN-safe), 0 on success. The factor freezes at a failed pivot and
    every stored value stays finite, except an input NaN at its own
    position. The launch takes NB² + 2·POTF2_KB·n floats of scratch (at
    most n² + NB²), freed on return."""
    n = _check_leaf(A, "potf2_f32")
    if A.device.type == "cpu":
        return potf2_plain(A)
    Winv = torch.empty((NB, NB), dtype=A.dtype, device=A.device)
    # the solved columns of a strip transposed: two strips' worth
    PT = torch.empty((min(2 * POTF2_KB, n) if n > NB else 1, n),
                     dtype=A.dtype, device=A.device)
    info = torch.empty((), dtype=torch.int32, device=A.device)
    _build.launch(
        "potf2_f32", A.data_ptr(), A.stride(0), Winv.data_ptr(),
        PT.data_ptr(), n, POTF2_KB, GEMM128_MIN_TILES, info.data_ptr(),
        *_build.device_args(A))
    potf2_f32.launches += 1
    return info


def unit_inverse(kern, L):
    """The unit-diagonal inverse through a non-unit inverse ``kern`` (the
    JAX package's trick, ``blocked.py:201-209``): invert tril(L, -1) + I,
    then put L's own diagonal back, which LAPACK passes through
    untouched."""
    n = L.shape[0]
    W, info = kern(torch.tril(L, -1) + torch.eye(n, dtype=L.dtype,
                                                 device=L.device))
    return torch.tril(W, -1) + torch.diag(torch.diagonal(L)), info


def trti2_plain(L, unit=False):
    """The plain torch version, any real dtype and device: (W, info) as
    :func:`trti2_f32` returns them, in the kernel's order of work
    (:func:`~cholesky_tpu_torch.ops.kernels.mega.trtri_block_plain`: the
    NB-wide leaves, then the levels of ``trtri_levels``); with ``unit`` on
    tril(L, -1) + I, L's diagonal then put back on W's."""
    return unit_inverse(trtri_block_plain, L) if unit \
        else trtri_block_plain(L)


@_build.kernel_span("trti2_f32")
def trti2_f32(L, unit=False):
    """Inverse of the lower-triangular f32 block L (n <= NB or a multiple
    of NB, no cap; unit-stride rows); only its lower triangle is read.
    Returns (W, info): W a new contiguous tensor with a zero strict upper;
    info (0-d int32) the 1-based index of the first zero diagonal, which
    is read as 1 and does not stop the inversion. With ``unit`` the
    diagonal is read as 1, info is 0 and W's diagonal is L's, passed
    through as LAPACK's xtrti2 leaves it. The launch takes no scratch
    beyond W: each level's B·A⁻¹ goes transposed into W's strict upper,
    which the last of its launches writes zero."""
    n = _check_leaf(L, "trti2_f32")
    if L.device.type == "cpu":
        return trti2_plain(L, unit)
    W = torch.empty((n, n), dtype=L.dtype, device=L.device)
    info = torch.empty((), dtype=torch.int32, device=L.device)
    _build.launch(
        "trti2_f32", L.data_ptr(), L.stride(0), W.data_ptr(), W.stride(0),
        n, int(unit), GEMM128_MIN_TILES, info.data_ptr(),
        *_build.device_args(L))
    trti2_f32.launches += 1
    return W, info


def lauu2_plain(A):
    """The plain torch version, any real dtype and device: tril(A)ᵀ·tril(A)
    in the lower triangle, A's strict upper above it; a new tensor."""
    T = torch.tril(A)
    n = A.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=A.device).tril_()
    return torch.where(lower, T.T @ T, A)


def lauu2_launch_plan(n):
    """(q, blocks) of lauu2_f32 at n: lauum_stream_f32's plan
    (mega.lauum_launch_plan), but below WAVE // 2 lower tiles the runs are
    cut for one block an SM, not two: a leaf's few tiles cut for a whole
    wave split each into twice the parts, and the sums of the parts cost
    more than the second block an SM gains (chip_smoke.py's A/B:
    PERF.md)."""
    nt = -(-n // NB)
    return mega.lauum_launch_plan(
        n, blocks=WAVE // 2 if nt * (nt + 1) // 2 < WAVE // 2 else None)


@_build.kernel_span("lauu2_f32")
def lauu2_f32(A):
    """Lower triangle of tril(A)ᵀ·tril(A) for the f32 block A (any n,
    unit-stride rows), strict upper passed through from A bit for bit.
    Returns a new contiguous tensor; A is not modified. The launch is
    lauum_stream_f32's tile and plan at any n (:func:`lauu2_launch_plan`);
    when its runs split tiles it also takes two NB x NB tiles of scratch a
    block on the card, freed on return."""
    n = _check_block(A, "lauu2_f32", LEAF_MAX_N)
    if A.device.type == "cpu":
        return lauu2_plain(A)
    q, blocks = lauu2_launch_plan(n)
    B = torch.empty((n, n), dtype=A.dtype, device=A.device)
    # where runs split tiles, two partial tiles a block
    P = (torch.empty((2 * blocks * NB * NB,), dtype=A.dtype,
                     device=A.device) if q and blocks > 1 else None)
    _build.launch(
        "lauu2_f32", A.data_ptr(), A.stride(0), B.data_ptr(), n, n, q,
        blocks, P.data_ptr() if P is not None else None,
        *_build.device_args(A))
    lauu2_f32.launches += 1
    return B


potf2_f32.launches = 0
trti2_f32.launches = 0
lauu2_f32.launches = 0
