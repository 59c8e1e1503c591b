"""Reference (oracle) LAPACK tier in plain torch, f32 and f64.

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
    ``A`` itself is not modified. Lower: A = L·Lᵀ with L in the lower
    triangle; upper: A = Uᵀ·U. The opposite strict triangle is returned
    unchanged."""
    uplo = norm_uplo(uplo)
    n = _square(A, "potf2")
    A = A.clone()
    info = _info0(A)
    # work on the lower form: for upper, Aᵀ is a view whose lower triangle
    # holds the selected data, and writes land in A's upper triangle
    W = A if uplo == Uplo.LOWER else A.T
    for j in range(n):
        frozen = info > 0                       # latched BEFORE this pivot
        rowm = W[j, :j]
        ajj = W[j, j] - torch.dot(rowm, rowm)
        bad = ~(ajj > 0)                        # NaN-safe
        info = torch.where(bad & (info == 0), j + 1, info)
        d = torch.sqrt(torch.where(bad, torch.ones_like(ajj), ajj))
        col = W[j + 1:, j]
        newcol = (col - W[j + 1:, :j] @ rowm) / d
        W[j + 1:, j] = torch.where(frozen, col, newcol)
        W[j, j] = torch.where(frozen, W[j, j], d)
    return A, info


# ---------------------------------------------------------------------------
# POTRF — blocked Cholesky (reference lapack/spotrf.c:84-147)
# ---------------------------------------------------------------------------

def potrf(uplo, A, block_size: int = 64):
    """Blocked Cholesky: syrk → potf2 → gemm → trsm per block column, the
    left-looking schedule of the reference CPU tier. ``A`` is not
    modified."""
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
        upd = Ajj - Ajl @ Ajl.T
        Ajj_in = torch.tril(upd) + torch.triu(Ajj, 1)
        F, linfo = potf2(Uplo.LOWER, Ajj_in)
        W[j:j + jb, j:j + jb] = F
        if j + jb < n:
            Apj = W[j + jb:, j:j + jb] - W[j + jb:, :j] @ Ajl.T
            W[j + jb:, j:j + jb] = torch.linalg.solve_triangular(
                torch.tril(F).T, Apj, upper=True, left=False)
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


# ---------------------------------------------------------------------------
# LOGDET (reference lapack/slogdet.c:10-25)
# ---------------------------------------------------------------------------

def logdet_from_factor(x):
    """2·Σ log(xᵢᵢ) over the Cholesky diagonal: pass the factored matrix
    (its diagonal is used) or a 1-D diagonal."""
    d = torch.diagonal(x) if x.ndim == 2 else x
    return 2.0 * torch.sum(torch.log(d.real))


def logdet(uplo, A, block_size: int = 64):
    """SPD log-determinant: potrf + log-diagonal reduction.
    Returns (value, info)."""
    F, info = potrf(uplo, A, block_size=block_size)
    return logdet_from_factor(F), info
