"""trmm_lln_f32: C = alpha·T·B, T = tril(L) (csrc/trmm.cu).

Replaces ``cholesky_tpu/ops/pallas/trmm.py:trmm_lln_f32``, the one kernel
onto which the public trmm canonicalizes all 16 side/uplo/trans/diag
combinations (ops/blocked.py ``_trmm_left_f32``). Only the triangle T of
L is read. L and B may be any strided views (a transposed view or a slice
costs no copy). ``upper`` takes T = triu(L) by the double reversal
T·B = flipud(rev(T)·flipud(B)), rev(T) lower: the same kernel on reversed
views, given as a pointer to the last row and negated strides, so no
operand is copied. ``unit`` reads T's diagonal as 1. A CPU tensor takes
the plain twin :func:`trmm_lln_plain`; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check


def trmm_lln_plain(L, B, alpha=1.0, upper=False, unit=False):
    """The plain torch version, any real dtype and device."""
    T = torch.triu(L) if upper else torch.tril(L)
    if unit:
        T.diagonal().fill_(1.0)
    return alpha * (T @ B)


def _trmm_shape(L, B, *args, **kwargs):
    return {"n": L.shape[0], "m": B.shape[1], "dtype": _build.dtype_name(B)}


@_build.kernel_span("trmm_lln_f32", _trmm_shape)
def trmm_lln_f32(L, B, alpha=1.0, upper=False, unit=False):
    """alpha·T·B for f32 L (n, n) and B (n, m), T = tril(L), or triu(L)
    with ``upper``, its diagonal read as 1 with ``unit``; only T is read.
    Returns a new contiguous (n, m) tensor."""
    check(L.ndim == 2 and L.shape[0] == L.shape[1], "trmm_lln_f32", 1,
          f"L must be square, got {tuple(L.shape)}")
    n = L.shape[0]
    check(B.ndim == 2 and B.shape[0] == n, "trmm_lln_f32", 2,
          f"B shape {tuple(B.shape)} does not match L ({n}x{n})")
    check(L.dtype == B.dtype == torch.float32, "trmm_lln_f32", 1,
          "float32 operands only")
    check(L.device == B.device, "trmm_lln_f32", 2,
          "operands on different devices")
    if L.device.type == "cpu":
        return trmm_lln_plain(L, B, alpha, upper, unit)
    check(L.device.type == "cuda", "trmm_lln_f32", 1,
          f"unsupported device {L.device}")
    m = B.shape[1]
    C = torch.empty((n, m), dtype=B.dtype, device=B.device)
    if n == 0 or m == 0:
        return C
    (sl0, sl1), (sb0, sb1), ldc = L.stride(), B.stride(), C.stride(0)
    pl, pb, pc = L.data_ptr(), B.data_ptr(), C.data_ptr()
    if upper:       # rev(T), flipud(B) and flipud(C): from the last rows
        last = (n - 1) * L.element_size()
        pl, pb, pc = pl + last * (sl0 + sl1), pb + last * sb0, pc + last * ldc
        sl0, sl1, sb0, ldc = -sl0, -sl1, -sb0, -ldc
    _build.launch(
        "trmm_lln_f32", pl, sl0, sl1, pb, sb0, sb1, pc, ldc, n, m,
        float(alpha), int(unit), *_build.device_args(C))
    trmm_lln_f32.launches += 1
    return C


trmm_lln_f32.launches = 0
