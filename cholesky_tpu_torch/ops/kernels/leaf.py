"""lauu2_f32: the lower triangle of LᵀL on one leaf block (csrc/lauum.cu).

Replaces ``cholesky_tpu/ops/pallas/leaf.py:lauu2_f32``, the leaf of the
lauum recursion. The strict upper of the result is the input's, bit for
bit, as in LAPACK's xlauu2. A CPU tensor takes the plain twin
:func:`lauu2_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.ops.kernels.mega import MAX_N, _check_block


def lauu2_plain(A):
    """The plain torch version, any real dtype and device: tril(A)ᵀ·tril(A)
    in the lower triangle, A's strict upper above it; a new tensor."""
    T = torch.tril(A)
    n = A.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=A.device).tril_()
    return torch.where(lower, T.T @ T, A)


def lauu2_f32(A):
    """Lower triangle of tril(A)ᵀ·tril(A) for the f32 block A (n <= MAX_N,
    unit-stride rows), strict upper passed through from A. Returns a new
    contiguous tensor; A is not modified."""
    n = _check_block(A, "lauu2_f32", MAX_N)
    if A.device.type == "cpu":
        return lauu2_plain(A)
    B = torch.empty((n, n), dtype=A.dtype, device=A.device)
    err = _build.library().ct_lauu2_f32(
        A.data_ptr(), A.stride(0), B.data_ptr(), B.stride(0), n,
        *_build.device_args(A))
    _build.check_launch(err, "lauu2_f32")
    lauu2_f32.launches += 1
    return B


lauu2_f32.launches = 0
