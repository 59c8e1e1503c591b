"""syrk_lower_f32: C := alpha·A·Aᵀ + beta·C, lower triangle, in place
(csrc/syrk.cu).

Replaces ``cholesky_tpu/ops/pallas/syrk.py:syrk_f32``. The strict upper
triangle of C is never written. A and C may be strided views of one
working buffer, but must not overlap. A CPU tensor takes the plain twin
:func:`syrk_lower_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check


def syrk_lower_plain(alpha, A, beta, C):
    """The plain torch version, any dtype and device: updates the lower
    triangle of C in place and returns C. A·Aᴴ for a complex A (the torch
    tile's Hermitian update); Aᴴ is Aᵀ for the kernel's real operands."""
    full = alpha * (A @ A.mH)
    if beta != 0.0:
        full = full + beta * C
    n = C.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=C.device).tril_()
    C.copy_(torch.where(lower, full, C))
    return C


def syrk_lower_f32(alpha, A, beta, C):
    """Lower triangle of C := alpha·A·Aᵀ + beta·C in place, A (n, k) and
    C (n, n) f32; C is read only when beta != 0. Returns C."""
    check(A.ndim == 2 and C.ndim == 2, "syrk_lower_f32", 2,
          "A and C must be 2-D")
    n, k = A.shape
    check(C.shape == (n, n), "syrk_lower_f32", 4,
          f"C shape {tuple(C.shape)} != {(n, n)}")
    check(A.dtype == C.dtype == torch.float32, "syrk_lower_f32", 2,
          "float32 operands only")
    check(A.device == C.device, "syrk_lower_f32", 2,
          "operands on different devices")
    check(_build.writable_2d(C), "syrk_lower_f32", 4,
          "C must be a row- or column-major view without overlap")
    if A.device.type == "cpu":
        return syrk_lower_plain(alpha, A, beta, C)
    check(A.device.type == "cuda", "syrk_lower_f32", 2,
          f"unsupported device {A.device}")
    if n == 0:
        return C
    err = _build.library().ct_syrk_lower_f32(
        A.data_ptr(), A.stride(0), A.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        n, k, float(alpha), float(beta), *_build.device_args(C))
    _build.check_launch(err, "syrk_lower_f32")
    syrk_lower_f32.launches += 1
    return C


syrk_lower_f32.launches = 0
