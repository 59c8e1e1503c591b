"""Distributed triangular solve against a block-cyclic lower factor.

The counterpart of ``cholesky_tpu/parallel/trsm.py:31-126`` (the
reference's cuMultiGPUStrsm after cuMultiGPUSpotrf, blas/strsm.c). The
right-hand side is replicated (tall-skinny, nrhs ≪ n). At each block step
the diagonal block is broadcast from its owner and solved on every rank,
and the substitution's updates travel as collectives:

  forward (L·X = B): column j of L is spread over the row-block owners:
      each rank puts the updates of its own rows past j into a buffer of
      those rows, and one all_reduce sums them;
  backward (op(L)·X = B, op = ᵀ or ᴴ): row block j lives on one owner,
      which broadcasts w = op(L_j)·x_j for the rows before j.

Collectives per call: forward nblk broadcasts and nblk − 1 all_reduces,
backward 2·nblk − 1 broadcasts (the last step has no rows to update).
The diagonal solve is ``torch.linalg.solve_triangular`` and the update a
matmul (TF32 off): in the JAX package both are XLA operations outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.parallel import comm
from cholesky_tpu_torch.parallel.blockcyclic import (BlockCyclic,
                                                     diag_block, first_live)
from cholesky_tpu_torch.types import Trans, norm_trans
from cholesky_tpu_torch.utils.errors import check


def _solve_lower(local, nb: int, group, R, j0: int = 0):
    """L·X = R in place, R holding the rows of global blocks j0 on: the
    forward substitution over blocks j0.., the solution's blocks before
    j0 taken as zero."""
    p, r = comm.world(group), comm.rank(group)
    nlocal, _, npad = local.shape
    nblk = npad // nb
    m = R.shape[1]
    for j in range(j0, nblk):
        rj = R[(j - j0) * nb:(j - j0 + 1) * nb]
        Ljj = diag_block(local, j, nb, group).tril_()
        rj.copy_(torch.linalg.solve_triangular(Ljj, rj, upper=False))
        if j + 1 == nblk:
            return
        # my rows past j: their update L[i, j]·x_j, scattered into the
        # buffer of rows j+1.. and summed over the ranks
        buf = torch.zeros(((nblk - j - 1) * nb, m), dtype=R.dtype,
                          device=R.device)
        l1 = first_live(j, p, r)
        if l1 < nlocal:
            upd = torch.matmul(local[l1:, :, j * nb:(j + 1) * nb], rj)
            g = r + torch.arange(l1, nlocal, device=R.device) * p
            buf.view(nblk - j - 1, nb, m)[g - j - 1] = upd
        R[(j + 1 - j0) * nb:] -= comm.all_reduce(buf, group)


def _solve_lower_t(local, nb: int, group, R, trans: Trans):
    """op(L)·X = R in place, op = ᵀ or ᴴ: the backward substitution."""
    p, r = comm.world(group), comm.rank(group)
    nblk = local.shape[2] // nb
    m = R.shape[1]

    def op(M):
        return M.mH if trans == Trans.CONJ_TRANS else M.mT

    for j in reversed(range(nblk)):
        rj = R[j * nb:(j + 1) * nb]
        Ljj = diag_block(local, j, nb, group).tril_()
        rj.copy_(torch.linalg.solve_triangular(op(Ljj), rj, upper=True))
        if j == 0:
            return
        # the owner's row block j updates every earlier row
        if r == j % p:
            w = torch.matmul(op(local[j // p, :, :j * nb]), rj)
        else:
            w = torch.empty((j * nb, m), dtype=R.dtype, device=R.device)
        R[:j * nb] -= comm.broadcast(w, j % p, group)


def trsm_factor_dist(fbc: BlockCyclic, B, trans="N"):
    """Solve op(L)·X = B against the distributed factor: B a replicated
    (n, nrhs) or (n,) tensor of the factor's dtype; returns the replicated
    X of B's shape. trans in {'N', 'T', 'C'}.

    (The general distributed triangular solve, any side/uplo/trans/diag
    with a wide B split over the ranks, is ``parallel/blas.py``'s
    ``trsm_dist``; this one is the factor-then-solve path.)"""
    trans = norm_trans(trans)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    check(B.ndim == 2 and B.shape[0] == fbc.n, "trsm_factor_dist", 2,
          f"B must have {fbc.n} rows, got {tuple(B.shape)}")
    check(B.dtype == fbc.local.dtype, "trsm_factor_dist", 2,
          f"B is {B.dtype}, the factor {fbc.local.dtype}")
    R = torch.zeros((fbc.npad, B.shape[1]), dtype=B.dtype,
                    device=fbc.local.device)
    R[:fbc.n] = B
    if trans == Trans.NO_TRANS:
        _solve_lower(fbc.local, fbc.nb, fbc.group, R)
    else:
        _solve_lower_t(fbc.local, fbc.nb, fbc.group, R, trans)
    X = R[:fbc.n]
    return X[:, 0] if squeeze else X
