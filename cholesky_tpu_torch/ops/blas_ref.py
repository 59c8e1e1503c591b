"""Reference (oracle) Level-3 BLAS tier in plain torch, all four
precisions.

The counterpart of ``cholesky_tpu/ops/blas_ref.py``: gemm/gemm2,
syrk/herk, trmm/trmm2 and trsm. Every routine returns a new tensor and
leaves its operands as they were (``gemm2``/``trmm2``, the reference's
out-of-place variants, are therefore the same routines). syrk and herk
write only the requested triangle and keep C's other one. It is the
port's ``backend="ref"``, and the oracle the blocked routines are tested
against.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.types import (Diag, Side, Trans, Uplo, norm_diag,
                                      norm_side, norm_trans, norm_uplo)
from cholesky_tpu_torch.utils.errors import check


def op(A, trans):
    """op(A) = A, Aᵀ or Aᴴ (Aᵀ for a real A)."""
    trans = norm_trans(trans)
    if trans == Trans.NO_TRANS:
        return A
    if trans == Trans.TRANS:
        return A.T
    return A.conj().T


def _tri(A, uplo, diag=Diag.NON_UNIT):
    """The uplo triangle of A (unit diagonal if diag='U'), the rest zero:
    the referenced part of a triangular operand."""
    T = torch.tril(A) if norm_uplo(uplo) == Uplo.LOWER else torch.triu(A)
    if norm_diag(diag) == Diag.UNIT:
        T = T - torch.diag(torch.diagonal(T)) + torch.eye(
            A.shape[0], dtype=A.dtype, device=A.device)
    return T


def _set_triangle(C, T, uplo):
    """T in the uplo triangle of C, C's other strict triangle unchanged."""
    if norm_uplo(uplo) == Uplo.LOWER:
        return torch.tril(T) + torch.triu(C, 1)
    return torch.triu(T) + torch.tril(C, -1)


def gemm(transa, transb, alpha, A, B, beta, C):
    """C := alpha·op(A)·op(B) + beta·C (reference blas/sgemm.c:34)."""
    oA, oB = op(A, transa), op(B, transb)
    m, k = oA.shape
    kb, n = oB.shape
    check(k == kb, "gemm", 5, f"inner dims {k} != {kb}")
    check(C.shape == (m, n), "gemm", 7,
          f"C shape {tuple(C.shape)} != {(m, n)}")
    return (alpha * (oA @ oB) + beta * C).to(C.dtype)


def gemm2(transa, transb, alpha, A, B, beta, C):
    """Out-of-place GEMM (reference cuXgemm2): :func:`gemm`."""
    return gemm(transa, transb, alpha, A, B, beta, C)


def syrk(uplo, trans, alpha, A, beta, C):
    """C := alpha·op(A)·op(A)ᵀ + beta·C in the uplo triangle of C, its
    other strict triangle kept (reference blas/ssyrk.c:34). 'C' on a
    complex A is refused: that update is :func:`herk`."""
    check(norm_trans(trans) != Trans.CONJ_TRANS or not A.is_complex(),
          "syrk", 2, "syrk with 'C' on complex operands: use herk")
    oA = op(A, trans)
    n = oA.shape[0]
    check(C.shape == (n, n), "syrk", 6,
          f"C shape {tuple(C.shape)} != {(n, n)}")
    return _set_triangle(C, alpha * (oA @ oA.T) + beta * C, uplo).to(C.dtype)


def herk(uplo, trans, alpha, A, beta, C):
    """C := alpha·op(A)·op(A)ᴴ + beta·C, alpha and beta real (reference
    blas/cherk.c); a complex result's diagonal is exactly real. 'T' on a
    complex A is refused: that update is :func:`syrk`."""
    check(norm_trans(trans) != Trans.TRANS or not A.is_complex(),
          "herk", 2, "herk with 'T' on complex operands: use syrk")
    oA = op(A, trans)
    n = oA.shape[0]
    check(C.shape == (n, n), "herk", 6,
          f"C shape {tuple(C.shape)} != {(n, n)}")
    out = (alpha * (oA @ oA.mH) + beta * C).to(C.dtype)
    if out.is_complex():
        out.diagonal().imag.zero_()
    return _set_triangle(C, out, uplo)


def trmm(side, uplo, transa, diag, alpha, A, B):
    """B := alpha·op(A)·B (left) or alpha·B·op(A) (right), A triangular;
    only its uplo triangle is referenced (reference blas/strmm.c)."""
    T = op(_tri(A, uplo, diag), transa)
    if norm_side(side) == Side.LEFT:
        check(A.shape[0] == B.shape[0], "trmm", 6, "dim mismatch")
        out = T @ B
    else:
        check(A.shape[0] == B.shape[1], "trmm", 6, "dim mismatch")
        out = B @ T
    return (alpha * out).to(B.dtype)


def trmm2(side, uplo, transa, diag, alpha, A, B):
    """Out-of-place TRMM (reference cuXtrmm2): :func:`trmm`."""
    return trmm(side, uplo, transa, diag, alpha, A, B)


def trsm(side, uplo, transa, diag, alpha, A, B):
    """B := alpha·op(A)⁻¹·B (left) or alpha·B·op(A)⁻¹ (right), A
    triangular; only its uplo triangle is referenced (reference
    blas/strsm.c)."""
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    unit = norm_diag(diag) == Diag.UNIT
    if side == Side.RIGHT:
        if transa == Trans.CONJ_TRANS and A.is_complex():
            # (Aᴴ)ᵀ = conj(A): solve conj(A)·Xᵀ = alpha·Bᵀ, that is
            # A·conj(Xᵀ) = conj(alpha)·conj(Bᵀ)
            alpha_c = (alpha.conj() if isinstance(alpha, torch.Tensor)
                       else complex(alpha).conjugate())
            out = trsm(Side.LEFT, uplo, Trans.NO_TRANS, diag, alpha_c, A,
                       B.mH)
            return out.mH.resolve_conj()
        # X·op(A) = alpha·B  <=>  op(A)ᵀ·Xᵀ = alpha·Bᵀ
        eff = Trans.TRANS if transa == Trans.NO_TRANS else Trans.NO_TRANS
        return trsm(Side.LEFT, uplo, eff, diag, alpha, A, B.T).T
    check(A.shape[0] == B.shape[0], "trsm", 6, "dim mismatch")
    T = op(_tri(A, uplo, diag), transa)
    upper = (uplo == Uplo.UPPER) == (transa == Trans.NO_TRANS)
    return torch.linalg.solve_triangular(T, alpha * B.to(T.dtype),
                                         upper=upper, unitriangular=unit)
