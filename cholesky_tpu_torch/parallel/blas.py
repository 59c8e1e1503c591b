"""Distributed Level-3 BLAS over a process group (the cuMultiGPU BLAS tier).

The counterpart of ``cholesky_tpu/parallel/blas.py:49-250`` (the
reference's cuMultiGPUSgemm, Ssyrk, Cherk, Strsm and Strmm). The JAX
package row-shards the output over a mesh axis and each device computes
its stripe in one SPMD program; here every rank holds the whole operands,
computes the same contiguous stripe that JAX's ``P(axis, ...)`` gives its
device, and one all_gather of the stripes gives every rank the whole
result:

  gemm_dist   rows of C and op(A), op(B) whole
  syrk_dist   rows of C and op(A) against the whole op(A)ᵀ
  herk_dist   rows of C and op(A) against the whole op(A)ᴴ
  trsm_dist   the independent dimension of B: columns for a left solve,
              rows for a right one; the triangle whole
  trmm_dist   as trsm_dist

The dimension split is padded with zeros to a multiple of the group
size, as JAX's ``_pad_rows`` pads it, and the padding is dropped after
the gather. Collectives per call: one all_gather, of the output.

The stripe products are ``_local_mm``: f64 on the card through the Ozaki
kernels (``ops.ozaki.matmul_f64``, as the d tier's tiles), everything
else ``torch.matmul`` with TF32 off (the JAX package computes it as an
XLA matmul outside any Pallas kernel). The trsm and trmm stripes run the
single-device routines ``ops.blocked.trsm``/``trmm``.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops import blas_ref, blocked, ozaki
from cholesky_tpu_torch.parallel import comm
from cholesky_tpu_torch.types import (Side, Trans, Uplo, norm_side,
                                      norm_trans, norm_uplo)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _local_mm(a, b):
    """One rank's stripe product: f64 on the card through the Ozaki int8
    kernels (native f64 is not the port's fast path, as in the d tier and
    ``parallel/potrf.py``'s tiles), everything else a full-precision
    matmul."""
    if a.dtype == torch.float64 and a.device.type == "cuda":
        return ozaki.matmul_f64(a, b, slices=6)
    return torch.matmul(a, b)


def _stripe(X, r: int, size: int, dim: int = 0):
    """Rows (dim 0) or columns (dim 1) r·size .. (r+1)·size of X, zero past
    its end: rank r's share of X padded to a multiple of the group."""
    part = X.narrow(dim, min(r * size, X.shape[dim]),
                    max(0, min(size, X.shape[dim] - r * size)))
    if part.shape[dim] == size:
        return part
    shape = list(X.shape)
    shape[dim] = size
    out = torch.zeros(shape, dtype=X.dtype, device=X.device)
    out.narrow(dim, 0, part.shape[dim]).copy_(part)
    return out


def _split(extent: int, group):
    """(this rank, the stripe size) of ``extent`` padded to the group."""
    p = comm.world(group)
    return comm.rank(group), _round_up(extent, p) // p


def _gathered(stripe, extent: int, group, dim: int = 0):
    """Every rank's stripe in rank order, cut back to ``extent``: one
    all_gather."""
    full = torch.cat(comm.all_gather(stripe, group), dim=dim)
    return full.narrow(dim, 0, extent)


def gemm_dist(transa, transb, alpha, A, B, beta, C, group=None):
    """C := alpha·op(A)·op(B) + beta·C, rows of C spread over the group.
    Returns the whole result on every rank."""
    oA = blas_ref.op(A, transa)
    oB = blas_ref.op(B, transb)
    m = oA.shape[0]
    r, rows = _split(m, group)
    out = alpha * _local_mm(_stripe(oA, r, rows), oB) \
        + beta * _stripe(C, r, rows)
    return _gathered(out.to(C.dtype), m, group)


def _rank_k(uplo, X, Y, alpha, beta, C, group, hermitian: bool):
    """The uplo triangle of alpha·X·Y + beta·C, C's other strict triangle
    kept, rows spread over the group; Hermitian: a real diagonal."""
    n = X.shape[0]
    r, rows = _split(n, group)
    c_loc = _stripe(C, r, rows)
    out = alpha * _local_mm(_stripe(X, r, rows), Y) + beta * c_loc
    gr = r * rows + torch.arange(rows, device=C.device)[:, None]
    gc = torch.arange(n, device=C.device)[None, :]
    if hermitian:
        out = torch.where(gc == gr, out.real.to(out.dtype), out)
    keep = gc <= gr if uplo == Uplo.LOWER else gc >= gr
    return _gathered(torch.where(keep, out, c_loc).to(C.dtype), n, group)


def syrk_dist(uplo, trans, alpha, A, beta, C, group=None):
    """Triangle-only C := alpha·op(A)·op(A)ᵀ + beta·C, rows of C spread
    over the group; C's other strict triangle kept.

    JAX all_gathers the row-sharded operand to form op(A)ᵀ and pads C in
    both dimensions to match the gathered product; here each rank holds
    op(A) whole, so its stripe is multiplied by the whole op(A)ᵀ (no
    operand gather) and only the rows are padded."""
    X = blas_ref.op(A, trans)            # (n, k)
    return _rank_k(norm_uplo(uplo), X, X.T, alpha, beta, C, group, False)


def herk_dist(uplo, trans, alpha, A, beta, C, group=None):
    """Triangle-only C := alpha·op(A)·op(A)ᴴ + beta·C (alpha, beta real),
    rows of C spread over the group, the diagonal real; real dtypes
    collapse to :func:`syrk_dist`. As in :func:`syrk_dist`, op(A) is held
    whole, so no operand gather is needed. (Reference cuMultiGPUCherk/
    Zherk, include/blas.h:275-287.)"""
    uplo = norm_uplo(uplo)
    if not A.is_complex():
        tr = "N" if norm_trans(trans) == Trans.NO_TRANS else "T"
        return syrk_dist(uplo, tr, alpha, A, beta, C, group)
    X = A if norm_trans(trans) == Trans.NO_TRANS else A.conj().T
    return _rank_k(uplo, X, X.conj().T, alpha, beta, C, group, True)


def _tri_dist(routine, side, uplo, transa, diag, alpha, A, B, group):
    """routine (blocked.trsm or trmm) on this rank's stripe of B's
    independent dimension: columns for a left operation (they do not
    couple), rows for a right one; the triangle whole on every rank."""
    side = norm_side(side)
    dim = 1 if side == Side.LEFT else 0
    extent = B.shape[dim]
    r, size = _split(extent, group)
    out = routine(side, uplo, transa, diag, alpha, A,
                 _stripe(B, r, size, dim)).to(B.dtype)
    return _gathered(out, extent, group, dim)


def trsm_dist(side, uplo, transa, diag, alpha, A, B, group=None):
    """General distributed triangular solve: X := alpha·inv(op(tri(A)))·B
    (left) or alpha·B·inv(op(tri(A))) (right), any uplo/trans/diag, B
    general (reference cuMultiGPUStrsm family, include/blas.h:338-362).

    A left solve couples the rows of B but not its columns, so each rank
    solves a stripe of columns against the whole triangle (rows for the
    right side) through the single-device ``blocked.trsm``: on the card
    f32 runs the kernels' leaves and f64 the Ozaki tiles."""
    return _tri_dist(blocked.trsm, side, uplo, transa, diag, alpha, A, B,
                     group)


def trmm_dist(side, uplo, transa, diag, alpha, A, B, group=None):
    """B := alpha·op(tri(A))·B (left) or alpha·B·op(tri(A)) (right), the
    same decomposition as :func:`trsm_dist`; each stripe runs the
    single-device ``blocked.trmm`` (on the card: one ``trmm_lln_f32``
    launch in f32, the Ozaki live-block recursion in f64)."""
    return _tri_dist(blocked.trmm, side, uplo, transa, diag, alpha, A, B,
                     group)
