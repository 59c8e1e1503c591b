"""Reference (oracle) Level-3 BLAS tier in plain torch, real dtypes.

The counterpart of ``cholesky_tpu/ops/blas_ref.py`` (op, _tri,
_set_triangle and trsm so far): every routine returns a new tensor and
leaves its operands as they were. It is the port's ``backend="ref"`` for
trsm, and the oracle the blocked trsm is tested against.
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


def trsm(side, uplo, transa, diag, alpha, A, B):
    """B := alpha·op(A)⁻¹·B (left) or alpha·B·op(A)⁻¹ (right), A
    triangular; only its uplo triangle is referenced (reference
    blas/strsm.c)."""
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    unit = norm_diag(diag) == Diag.UNIT
    if side == Side.RIGHT:
        # X·op(A) = alpha·B  <=>  op(A)ᵀ·Xᵀ = alpha·Bᵀ (real dtypes)
        eff = Trans.TRANS if transa == Trans.NO_TRANS else Trans.NO_TRANS
        return trsm(Side.LEFT, uplo, eff, diag, alpha, A, B.T).T
    check(A.shape[0] == B.shape[0], "trsm", 6, "dim mismatch")
    T = _tri(A, uplo, diag)
    upper = uplo == Uplo.UPPER
    if transa != Trans.NO_TRANS:
        T, upper = T.T, not upper
    return torch.linalg.solve_triangular(T, alpha * B.to(T.dtype),
                                         upper=upper, unitriangular=unit)
