"""Reference (oracle) LAPACK tier in plain torch, all four precisions.

The counterpart of ``cholesky_tpu/ops/lapack_ref.py``, kept branch-free in
the same way: every routine returns ``info`` as a 0-d int32 tensor on the
operand's device (0 on success, else the 1-based index of the first failed
pivot) and combines it with ``torch.where``, so nothing waits for the
device inside a sweep. It is the port's ``backend="ref"``, the leaves of
its torch tile, and the plain twin of the whole-block kernels.

Freeze semantics, as in the reference's spotf2 which returns at the bad
pivot: the failing column is written with its pivot clamped to 1, and
every later column keeps the values it had.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops import blas_ref
from cholesky_tpu_torch.types import Diag, Uplo, norm_diag, norm_uplo
from cholesky_tpu_torch.utils.errors import check


def _square(A, name):
    check(A.ndim == 2 and A.shape[0] == A.shape[1], name, 2,
          f"expected square matrix, got {tuple(A.shape)}")
    return A.shape[0]


def _info0(A):
    return torch.zeros((), dtype=torch.int32, device=A.device)


# ---------------------------------------------------------------------------
# POTF2 — unblocked Cholesky (reference lapack/spotrf.c:35-82)
# ---------------------------------------------------------------------------

def potf2(uplo, A):
    """Unblocked Cholesky of the uplo triangle. Returns (A_factored, info);
    ``A`` itself is not modified. Lower: A = L·Lᴴ with L in the lower
    triangle; upper: A = Uᴴ·U. The opposite strict triangle is returned
    unchanged. A complex factor has a real diagonal."""
    uplo = norm_uplo(uplo)
    n = _square(A, "potf2")
    A = A.clone()
    info = _info0(A)
    # work on the lower form: for upper, Aᵀ is a view whose lower triangle
    # holds the selected data, and writes land in A's upper triangle (Aᵀ
    # is Hermitian too, and its lower factor is Uᵀ)
    W = A if uplo == Uplo.LOWER else A.T
    for j in range(n):
        frozen = info > 0                       # latched BEFORE this pivot
        rowm = W[j, :j]
        # the pivot is real: Re a_jj − Σ |l_jk|²
        ajj = W[j, j].real - torch.vdot(rowm, rowm).real
        bad = ~(ajj > 0)                        # NaN-safe
        info = torch.where(bad & (info == 0), j + 1, info)
        d = torch.sqrt(torch.where(bad, torch.ones_like(ajj), ajj))
        col = W[j + 1:, j]
        newcol = (col - W[j + 1:, :j] @ rowm.conj()) / d
        W[j + 1:, j] = torch.where(frozen, col, newcol)
        W[j, j] = torch.where(frozen, W[j, j], d)
    return A, info


# ---------------------------------------------------------------------------
# POTRF — blocked Cholesky (reference lapack/spotrf.c:84-147)
# ---------------------------------------------------------------------------

def potrf(uplo, A, block_size: int = 64):
    """Blocked Cholesky: syrk (herk) → potf2 → gemm → trsm per block
    column, the left-looking schedule of the reference CPU tier. ``A`` is
    not modified."""
    uplo = norm_uplo(uplo)
    n = _square(A, "potrf")
    nb = block_size
    if n <= nb:
        return potf2(uplo, A)
    A = A.clone()
    W = A if uplo == Uplo.LOWER else A.T       # lower form, as in potf2
    info = _info0(A)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        Ajj = W[j:j + jb, j:j + jb]
        Ajl = W[j:j + jb, :j]
        # the lower form of an upper complex matrix is Aᵀ = conj(A), whose
        # lower factor L satisfies L·Lᴴ = Aᵀ: every product is with Lᴴ
        upd = Ajj - Ajl @ Ajl.mH
        Ajj_in = torch.tril(upd) + torch.triu(Ajj, 1)
        F, linfo = potf2(Uplo.LOWER, Ajj_in)
        W[j:j + jb, j:j + jb] = F
        if j + jb < n:
            Apj = W[j + jb:, j:j + jb] - W[j + jb:, :j] @ Ajl.mH
            W[j + jb:, j:j + jb] = torch.linalg.solve_triangular(
                torch.tril(F).mH, Apj, upper=True, left=False)
        # first failure, offset by the block (reference spotrf.c:112-115)
        info = torch.where((info == 0) & (linfo > 0), linfo + j, info)
    return A, info


# ---------------------------------------------------------------------------
# TRTI2 — triangular inverse (reference lapack/strtri.c:43-164)
# ---------------------------------------------------------------------------

def trti2(uplo, diag, A):
    """Unblocked triangular inverse. Returns (A_inv, info); ``A`` itself
    is not modified. A zero diagonal sets info, is treated as 1 and does
    not stop the sweep. Lower runs from the last column backwards, upper
    from the first forwards, so info is the first zero in that order."""
    uplo = norm_uplo(uplo)
    unit = norm_diag(diag) == Diag.UNIT
    n = _square(A, "trti2")
    A = A.clone()
    info = _info0(A)
    lower = uplo == Uplo.LOWER
    for j in (range(n - 1, -1, -1) if lower else range(n)):
        ajj_old = A[j, j]
        if unit:
            ajj = torch.ones_like(ajj_old)
        else:
            bad = ajj_old == 0
            info = torch.where(bad & (info == 0), j + 1, info)
            ajj = 1.0 / torch.where(bad, torch.ones_like(ajj_old), ajj_old)
        # the columns already visited hold the inverse of their block
        if lower:
            colm = A[j + 1:, j]
            T = torch.tril(A[j + 1:, j + 1:], -1 if unit else 0)
        else:
            colm = A[:j, j]
            T = torch.triu(A[:j, :j], 1 if unit else 0)
        v = T @ colm
        if unit:
            v = v + colm
        if lower:
            A[j + 1:, j] = -ajj * v
        else:
            A[:j, j] = -ajj * v
        if not unit:
            A[j, j] = ajj
    return A, info


def trtri(uplo, diag, A):
    """Triangular inverse (reference strtri.c:43-164): the unblocked sweep,
    as at this tier of the JAX package (the blocked one is ops/blocked.py).
    """
    return trti2(uplo, diag, A)


def trtri2(uplo, diag, A):
    """Out-of-place triangular inverse (reference strtri2,
    strtri.c:166-299): the same computation; ``A`` is never modified."""
    return trti2(uplo, diag, A)


# ---------------------------------------------------------------------------
# LAUU2 / LAUUM — triangular square (reference lapack/slauum.c:43-129)
# ---------------------------------------------------------------------------

def lauu2(uplo, A):
    """U·Uᴴ (upper) or Lᴴ·L (lower) of the uplo triangle, stored in that
    triangle; the opposite strict triangle is returned unchanged (LAPACK
    xlauu2 semantics). A complex result's diagonal is exactly real. ``A``
    itself is not modified."""
    uplo = norm_uplo(uplo)
    _square(A, "lauu2")
    if uplo == Uplo.UPPER:
        U = torch.triu(A)
        prod = U @ U.mH
    else:
        L = torch.tril(A)
        prod = L.mH @ L
    if prod.is_complex():
        prod.diagonal().imag.zero_()
    return blas_ref._set_triangle(A, prod, uplo)


def lauum(uplo, A):
    """The blocked version collapses to the same computation at this
    tier."""
    return lauu2(uplo, A)


# ---------------------------------------------------------------------------
# POTRI — SPD inverse from the Cholesky factor (reference lapack/spotri.c)
# ---------------------------------------------------------------------------

def potri(uplo, A):
    """``A`` holds the Cholesky factor (from potrf); returns (A_inv, info)
    with the inverse in the uplo triangle: trtri then lauum, the pure
    composition of every tier of the reference (spotri.c)."""
    W, info = trtri(uplo, Diag.NON_UNIT, A)
    return lauum(uplo, W), info


# ---------------------------------------------------------------------------
# LOGDET (reference lapack/slogdet.c:10-25)
# ---------------------------------------------------------------------------

def logdet_from_factor(x):
    """2·Σ log(xᵢᵢ) over the Cholesky diagonal: pass the factored matrix
    (its diagonal is used) or a 1-D diagonal."""
    d = torch.diagonal(x) if x.ndim == 2 else x
    return 2.0 * torch.sum(torch.log(d.real))


def logdet(uplo, A, block_size: int = 64):
    """SPD (HPD) log-determinant: potrf + log-diagonal reduction.
    Returns (value, info)."""
    F, info = potrf(uplo, A, block_size=block_size)
    return logdet_from_factor(F), info
