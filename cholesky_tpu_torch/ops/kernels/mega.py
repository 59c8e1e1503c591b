"""Whole-block kernels: potrf_block_f32 (csrc/potrf_block.cu) and
trtri_block_f32 (csrc/trtri_block.cu).

They replace ``cholesky_tpu/ops/pallas/mega.py:potrf_vmem_f32`` and
``trtri_vmem_f32`` and keep their limits: a block of n <= MAX_N, and the
blocked recursion hands them n <= NB or a multiple of NB. A CPU tensor takes
the plain twin (the oracle tier's sweeps); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check

NB = 128            # the blocked recursion's granularity for these kernels
MAX_N = 1024        # one thread block holds a 32-wide panel of this height


def _check_block(A, name):
    check(A.ndim == 2 and A.shape[0] == A.shape[1], name, 1,
          f"expected a square block, got {tuple(A.shape)}")
    n = A.shape[0]
    check(A.dtype == torch.float32, name, 1, "float32 only")
    check(1 <= n <= MAX_N, name, 1, f"n={n} outside 1..{MAX_N}")
    check(A.stride(1) == 1 and A.stride(0) >= n, name, 1,
          "rows must be unit-stride (a row-major block or a slice of one)")
    return n


def potrf_block_plain(A):
    """The plain torch version, any real dtype and device: factors the
    lower triangle of A in place, zeroes the strict upper, returns info."""
    F, info = lapack_ref.potf2("L", A)
    A.copy_(torch.tril(F))
    return info


def trtri_block_plain(L):
    """The plain torch version, any real dtype and device: returns
    (inverse of tril(L) with the strict upper zero, info), info the first
    zero diagonal."""
    W, _ = lapack_ref.trti2("L", "N", L)
    zero = torch.diagonal(L) == 0
    info = torch.where(zero.any(), zero.int().argmax() + 1, 0).to(torch.int32)
    return torch.tril(W), info


def potrf_block_f32(A):
    """Lower Cholesky of the f32 block A (n <= MAX_N, unit-stride rows), in
    place: only the lower triangle is read, the strict upper is zeroed.
    Returns info, a 0-d int32 tensor on A's device: the 1-based index of
    the first pivot with !(d > 0) (NaN-safe), 0 on success. The factor
    freezes at a failed pivot and every stored value stays finite, except
    an input NaN at its own position."""
    n = _check_block(A, "potrf_block_f32")
    if A.device.type == "cpu":
        return potrf_block_plain(A)
    check(A.device.type == "cuda", "potrf_block_f32", 1,
          f"unsupported device {A.device}")
    info = torch.empty((), dtype=torch.int32, device=A.device)
    err = _build.library().ct_potrf_block_f32(
        A.data_ptr(), A.stride(0), n, info.data_ptr(),
        *_build.device_args(A))
    _build.check_launch(err, "potrf_block_f32")
    potrf_block_f32.launches += 1
    return info


def trtri_block_f32(L):
    """Inverse of the lower-triangular f32 block L (n <= MAX_N,
    unit-stride rows); only its lower triangle is read. Returns (W, info):
    W a new contiguous tensor with a zero strict upper, info (0-d int32)
    the 1-based index of the first zero diagonal, which is treated as 1
    and does not stop the inversion."""
    n = _check_block(L, "trtri_block_f32")
    if L.device.type == "cpu":
        return trtri_block_plain(L)
    check(L.device.type == "cuda", "trtri_block_f32", 1,
          f"unsupported device {L.device}")
    W = torch.empty((n, n), dtype=L.dtype, device=L.device)
    info = torch.empty((), dtype=torch.int32, device=L.device)
    err = _build.library().ct_trtri_block_f32(
        L.data_ptr(), L.stride(0), W.data_ptr(), W.stride(0), n,
        info.data_ptr(), *_build.device_args(L))
    _build.check_launch(err, "trtri_block_f32")
    trtri_block_f32.launches += 1
    return W, info


potrf_block_f32.launches = 0
trtri_block_f32.launches = 0
