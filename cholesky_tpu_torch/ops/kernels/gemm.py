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


#: from this many 128 x 128 output tiles a launch takes the 128 x 128 tile,
#: below it the 64 x 64 one, whose grid is four times as wide: about three
#: quarters of a wave on the H100's 132 SMs. The A/B of chip_smoke.py's
#: phase 3 on the paths' shapes: at 64 tiles the two within 10 % either
#: way, from 96 on the 128 x 128 launch 28-54 % faster.
GEMM128_MIN_TILES = 96


def _k_fast(s_r, s_k):
    """Is the operand with element (r, k) at r·s_r + k·s_k staged along k
    (k-fast) rather than along r? Its unit-stride axis, else the one of
    the smaller stride."""
    if s_k == 1 or s_r == 1:
        return s_k == 1
    return abs(s_k) <= abs(s_r)


def _on_grid(ptr, s_r, s_k, k_fast):
    """Can the operand be staged by 16-byte copies: unit stride on its
    fast axis, the other stride a multiple of 4 floats, a 16-byte aligned
    base?"""
    unit, lead = (s_k, s_r) if k_fast else (s_r, s_k)
    return unit == 1 and lead % 4 == 0 and ptr % 16 == 0


def launch_plan(m, n, a_strides, a_ptr, b_strides, b_ptr):
    """The launch of gemm_f32 for an (m x k)·(k x n) product of f32
    operands with these strides (in elements) and base addresses: (tile
    edge, A k-fast, Bᵀ k-fast, 16-byte staging). The tile is 128 where
    the grid has GEMM128_MIN_TILES tiles of 128 or more, else 64; the rest
    only matters to the 128 tile, which stages A as (r, k) = (row, col) and
    Bᵀ as (r, k) = (col, row)."""
    tiles = -(-m // 128) * -(-n // 128)
    tile = 128 if tiles >= GEMM128_MIN_TILES else 64
    a_kf = _k_fast(a_strides[0], a_strides[1])
    b_kf = _k_fast(b_strides[1], b_strides[0])
    vec = (_on_grid(a_ptr, a_strides[0], a_strides[1], a_kf)
           and _on_grid(b_ptr, b_strides[1], b_strides[0], b_kf))
    return tile, a_kf, b_kf, vec


def _gemm_shape(A, B, C=None, *, beta=0.0, **kwargs):
    return {"m": A.shape[0], "n": B.shape[1], "k": A.shape[1],
            "dtype": _build.dtype_name(A),
            "c_read": C is not None and beta != 0.0}


@_build.kernel_span("gemm_f32", _gemm_shape)
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
    plan = launch_plan(m, n, A.stride(), A.data_ptr(), B.stride(),
                       B.data_ptr())
    _build.launch(
        "gemm_f32", A.data_ptr(), A.stride(0), A.stride(1),
        B.data_ptr(), B.stride(0), B.stride(1),
        Cp.data_ptr(), Cp.stride(0), Cp.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        m, n, k, float(alpha), float(beta), *(int(v) for v in plan),
        *_build.device_args(out))
    gemm_f32.launches += 1
    return out


gemm_f32.launches = 0
