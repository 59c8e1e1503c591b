"""Distributed triangular inverse, triangular square and SPD inverse.

The counterpart of ``cholesky_tpu/parallel/trtri.py:36-166`` (the
reference's cuMultiGPUStrtri strtri.c:474-534, cuMultiGPUSlauum
slauum.c:308+, cuMultiGPUSpotri spotri.c:48-69) on the block-cyclic
layout:

- trtri_dist: an ascending sweep over the column blocks. The diagonal
  block is broadcast and inverted on every rank (W_jj); the owners of
  the blocks past j compute −L[:, j]·W_jj, one all_gather replicates it,
  and the forward substitution of the trsm tier solves
  L·W[:, j] = −L[:, j]·W_jj over the blocks past j (the blocks up to j
  of the solution are zero). Ascending order touches only finished
  columns, so it works in place.
- lauum_dist: W → WᴴW in one shot: every rank forms Σ WₗᴴWₗ over its
  own masked row slabs, one all_reduce assembles the product, and the
  owners take their rows from it. One collective in all.
- potri_dist: trtri then lauum, the reference's composition.

Collectives of trtri_dist: per column step j one broadcast, and for
j < nblk − 1 one all_gather and the inner solve's nblk − 1 − j
broadcasts and nblk − 2 − j all_reduces: nblk(nblk + 1)/2 broadcasts,
nblk − 1 all_gathers and (nblk − 1)(nblk − 2)/2 all_reduces.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops import blocked, lapack_ref
from cholesky_tpu_torch.parallel import comm
from cholesky_tpu_torch.parallel.blockcyclic import (BlockCyclic, collect,
                                                     diag_block, distribute,
                                                     first_live)
from cholesky_tpu_torch.parallel.potrf import _dist_tiles, _mm
from cholesky_tpu_torch.parallel.trsm import _solve_lower
from cholesky_tpu_torch.types import Diag, Uplo, norm_uplo


def trtri_dist(bc: BlockCyclic, tiles: str = "auto"):
    """Distributed lower triangular inverse (non-unit). Returns
    (BlockCyclic inverse, info); ``bc`` is not modified. A zero diagonal
    sets info (1-based, global) and is read as 1; it does not stop the
    sweep. tiles as in :func:`~cholesky_tpu_torch.parallel.potrf_dist`:
    the diagonal inverses on ``trtri_block_f32`` and the products on
    ``gemm_f32`` for f32 on the card."""
    local = bc.local.clone()
    nb, group = bc.nb, bc.group
    p, r = comm.world(group), comm.rank(group)
    nlocal, _, npad = local.shape
    nblk = npad // nb
    t = _dist_tiles(local, nb, tiles)
    mm = _mm(t)
    info = torch.zeros((), dtype=torch.int32, device=local.device)
    for j in range(nblk):
        c0, c1 = j * nb, (j + 1) * nb
        Ljj = diag_block(local, j, nb, group)
        if t is None:
            Wjj, linfo = lapack_ref.trti2(Uplo.LOWER, Diag.NON_UNIT, Ljj)
        else:
            Wjj, linfo = t.trti2(Ljj)
        Wjj = torch.tril(Wjj)
        info = torch.where((info == 0) & (linfo > 0), linfo + c0, info)
        if j + 1 < nblk:
            # −L[i, j]·W_jj for my blocks past j, gathered as in potrf
            # from local block l0 = j // p on
            l0, l1 = j // p, first_live(j, p, r)
            k = nlocal - l1
            send = torch.zeros((nlocal - l0, nb, nb), dtype=local.dtype,
                               device=local.device)
            if k:
                send[l1 - l0:] = mm(local[l1:, :, c0:c1].view(k * nb, nb),
                                    Wjj, alpha=-1.0).view(k, nb, nb)
            rhs = torch.stack(comm.all_gather(send, group), dim=1)
            rhs = rhs.reshape(-1, nb)[(j + 1 - l0 * p) * nb:]
            # columns past j of `local` still hold L
            _solve_lower(local, nb, group, rhs, j + 1)
            if k:
                g = r + torch.arange(l1, nlocal, device=local.device) * p
                local[l1:, :, c0:c1] = rhs.view(-1, nb, nb)[g - j - 1]
        if r == j % p:
            local[j // p, :, c0:c1] = Wjj
    return BlockCyclic(local=local, n=bc.n, nb=nb, group=group), info


def lauum_dist(bc: BlockCyclic) -> BlockCyclic:
    """Distributed Lᴴ·L of a block-cyclic lower factor: the lower triangle
    of the result; the strict upper region of the slabs passes through."""
    local, nb = bc.local, bc.nb
    p, r = comm.world(bc.group), comm.rank(bc.group)
    nlocal, _, npad = local.shape
    dev = local.device
    g = r + torch.arange(nlocal, device=dev) * p
    # slab l, entry [i, c] is in the lower triangle iff c <= g[l]·nb + i
    grow = g[:, None] * nb + torch.arange(nb, device=dev)[None, :]
    lower = torch.arange(npad, device=dev) <= grow[:, :, None]
    W = torch.where(lower, local, 0).view(nlocal * nb, npad)
    G = comm.all_reduce(W.mH @ W, bc.group)
    mine = G.view(npad // nb, nb, npad)[g]
    return BlockCyclic(local=torch.where(lower, mine, local), n=bc.n, nb=nb,
                       group=bc.group)


def potri_dist(bc: BlockCyclic):
    """Distributed SPD inverse from the distributed Cholesky factor:
    trtri_dist then lauum_dist (reference cuMultiGPUSpotri,
    spotri.c:48-69). Returns (BlockCyclic, info)."""
    W, info = trtri_dist(bc)
    return lauum_dist(W), info


def potri_sharded(uplo, A, group=None, nb: int = 256):
    """distribute a replicated Cholesky factor, invert, collect: the
    inverse in the uplo triangle, the opposite strict triangle A's."""
    uplo = norm_uplo(uplo)
    out, info = potri_dist(distribute(blocked._to_lower(A, uplo), group,
                                      nb=nb))
    R = collect(out)
    return blocked._merge_triangle(blocked._from_lower(R, uplo), A, uplo), \
        info
