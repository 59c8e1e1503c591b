"""Block-cyclic distribution of a dense matrix over a process group.

The counterpart of ``cholesky_tpu/parallel/blockcyclic.py:28-96`` (and of
the reference's multi-GPU layer, multigpu/multigpu.c): the n×n matrix is
padded to nblk·nb rows, split into nblk row blocks of nb rows, and row
block g lives on rank g mod P: rank r holds the blocks r, r+P, r+2P, ...
in local order, the ScaLAPACK 1-D cyclic layout. Rank r's ``local`` is,
bit for bit, the shard the JAX package puts on device r of its mesh for
the same matrix, nb and P.
"""

from __future__ import annotations

import dataclasses

import torch

from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.parallel import comm


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BlockCyclic:
    """A block-cyclically distributed square matrix, as one rank sees it.

    ``local``: (nlocal, nb, npad), this rank's row blocks r, r+P, ...;
    ``n``: the logical (unpadded) dimension; npad = nblk·nb >= n;
    ``group``: the process group (None: the default one, or a world of
    one when no group is initialised).
    """
    local: torch.Tensor
    n: int
    nb: int
    group: object = None

    @property
    def npad(self) -> int:
        return self.local.shape[2]

    @property
    def nblk(self) -> int:
        return self.npad // self.nb


def distribute(A, group=None, nb: int = 256,
               pad_identity: bool = True) -> BlockCyclic:
    """This rank's share of the replicated square matrix ``A``.

    n is padded up to round_up(max(n, nb), nb·P) so that every rank holds
    the same number of blocks; the pad is an identity block (exact for
    the triangular drivers) unless ``pad_identity`` is False. ``local``
    is a new tensor on A's device. Each rank copies its own blocks, so
    the JAX package's global permutation (``_perm``) is not needed."""
    n = lapack_ref._square(A, "distribute")
    p, r = comm.world(group), comm.rank(group)
    npad = _round_up(max(n, nb), nb * p)
    nlocal = npad // nb // p
    local = torch.zeros((nlocal, nb, npad), dtype=A.dtype, device=A.device)
    for l in range(nlocal):
        g0 = (r + l * p) * nb
        rows = min(nb, n - g0)
        if rows > 0:
            local[l, :rows, :n] = A[g0:g0 + rows]
        if pad_identity and g0 + nb > n:
            i = torch.arange(max(g0, n), g0 + nb, device=A.device)
            local[l, i - g0, i] = 1
    return BlockCyclic(local=local, n=n, nb=nb, group=group)


def collect(bc: BlockCyclic) -> torch.Tensor:
    """The replicated (n, n) matrix, on every rank (inverse of
    :func:`distribute`): one all_gather of the shards."""
    parts = comm.all_gather(bc.local, bc.group)
    full = torch.stack(parts, dim=1).reshape(bc.npad, bc.npad)
    return full[:bc.n, :bc.n]


def first_live(j: int, p: int, r: int) -> int:
    """The first local block of rank r whose global block is past j."""
    return max(0, (j - r) // p + 1)


def diag_block(local, j: int, nb: int, group=None):
    """A new copy of the diagonal block (j, j) on every rank, broadcast
    from its owner."""
    p, r = comm.world(group), comm.rank(group)
    if r == j % p:
        D = local[j // p, :, j * nb:(j + 1) * nb].clone(
            memory_format=torch.contiguous_format)
    else:
        D = torch.empty((nb, nb), dtype=local.dtype, device=local.device)
    return comm.broadcast(D, j % p, group)
