"""gemm_f32: D = alpha·A·B + beta·C (csrc/gemm.cu).

Replaces ``cholesky_tpu/ops/pallas/gemm.py:matmul_f32``. A, B, C and D may
be any strided views (a transposed view or a slice of the working buffer
costs no copy), and C may be the same memory as ``out`` for an in-place
update. A CPU tensor takes the plain twin :func:`gemm_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check


def gemm_plain(A, B, C=None, *, alpha=1.0, beta=0.0, out=None):
    """The plain torch version, any real dtype and device; the torch tile
    backend and the kernel's comparison use it."""
    D = alpha * (A @ B)
    if C is not None and beta != 0.0:
        D = D + beta * C
    if out is None:
        return D
    out.copy_(D)
    return out


def gemm_f32(A, B, C=None, *, alpha=1.0, beta=0.0, out=None):
    """D = alpha·A·B + beta·C for f32 matrices, A (m, k), B (k, n), C and
    ``out`` (m, n). C is read only when beta != 0. ``out`` is allocated
    when not given and may alias C, never A or B. Returns D."""
    check(A.ndim == 2 and B.ndim == 2, "gemm_f32", 1, "A and B must be 2-D")
    m, k = A.shape
    check(B.shape[0] == k, "gemm_f32", 2,
          f"inner dims {tuple(A.shape)} x {tuple(B.shape)}")
    n = B.shape[1]
    check(beta == 0.0 or C is not None, "gemm_f32", 3, "beta != 0 needs C")
    if out is None:
        out = torch.empty((m, n), dtype=A.dtype, device=A.device)
    mats = [A, B, out] + ([C] if C is not None else [])
    check(all(t.dtype == torch.float32 for t in mats), "gemm_f32", 1,
          "float32 operands only")
    check(all(t.device == A.device for t in mats), "gemm_f32", 1,
          "operands on different devices")
    check(out.shape == (m, n) and (C is None or C.shape == (m, n)),
          "gemm_f32", 3, f"C/out must be {(m, n)}")
    check(_build.writable_2d(out), "gemm_f32", 3,
          "out must be a row- or column-major view without overlap")
    if A.device.type == "cpu":
        return gemm_plain(A, B, C, alpha=alpha, beta=beta, out=out)
    check(A.device.type == "cuda", "gemm_f32", 1,
          f"unsupported device {A.device}")
    if m == 0 or n == 0:
        return out
    Cp = C if C is not None else out
    err = _build.library().ct_gemm_f32(
        A.data_ptr(), A.stride(0), A.stride(1),
        B.data_ptr(), B.stride(0), B.stride(1),
        Cp.data_ptr(), Cp.stride(0), Cp.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        m, n, k, float(alpha), float(beta), *_build.device_args(out))
    _build.check_launch(err, "gemm_f32")
    gemm_f32.launches += 1
    return out


gemm_f32.launches = 0
