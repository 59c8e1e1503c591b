"""Distributed block-cyclic Cholesky and log-determinant over a process
group.

The counterpart of ``cholesky_tpu/parallel/potrf.py:47-295`` (the
reference's cuMultiGPUSpotrf, lapack/spotrf.c:400-468). Every rank runs
the same eager loop on its own row blocks; step j:

  the diagonal block (j, j), broadcast from its owner, is factored on
      every rank (L, T = L⁻¹ and its info: cheaper than a second
      broadcast);
  panel: my row blocks past j get A[i,j]·Tᴴ (the inverse trick,
      hybridSpotrf spotrf.c:252-256), the owner's block j gets L;
  one all_gather of the panel column;
  with lookahead, the owner of block j+1 folds A[j+1,j+1] − P·Pᴴ from its
      own panel block P and broadcasts it, and every rank factors it
      before the trailing update is enqueued (the reference's stream
      overlap, spotrf.c:311-313);
  trailing update of my row blocks past j over the live columns.

Where the JAX program keeps every shape static (a masked full-window
update, shrunk in ``phases`` static stages), the eager loop computes the
live blocks only: the panel on this rank's suffix of blocks past j, and
the trailing update as one product into the view local[l1:, :,
(j+1)·nb:]. That is the same arithmetic on each live entry.

At the first failed pivot the failing block keeps its partial factor,
the panel and trailing update are skipped and the run stops, as the
reference's host loop does. The decision is taken from the broadcast
diagonal's info, which every rank computes from the same data with the
same kernel, so all ranks leave the loop at the same step and none waits
in a collective that the others never enter.

The tiles are the single-device ones (``ops/blocked.py``), as the JAX
package's ``_dist_tiles`` takes its ``_PallasTiles``/``_OzakiTiles``.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops import blocked, lapack_ref
from cholesky_tpu_torch.ops.kernels.gemm import gemm_plain
from cholesky_tpu_torch.parallel import comm
from cholesky_tpu_torch.parallel.blockcyclic import (BlockCyclic, collect,
                                                     diag_block, distribute,
                                                     first_live)
from cholesky_tpu_torch.types import Diag, Uplo, norm_uplo
from cholesky_tpu_torch.utils.errors import check

TILES = ("auto", "ref", "fast")


def _dist_tiles(local, nb: int, tiles: str):
    """The tile backend of the tier, None for the oracle (ops/lapack_ref),
    by the JAX package's rules (``parallel/potrf.py:51-68``): the oracle
    under 'ref' or for a block no whole-matrix kernel takes; f32 on the
    kernels (their twins on the CPU); f64 on the d tier where ``auto``
    puts it (the card) or anywhere under 'fast'; complex on the oracle."""
    check(tiles in TILES, "potrf_dist", 2,
          f"unknown tiles {tiles!r}; expected one of {TILES}")
    if tiles == "ref" or not blocked._mega_ok(nb):
        return None
    cuda = local.device.type == "cuda"
    if local.dtype == torch.float32:
        return blocked._KernelTiles() if cuda else blocked._TorchTiles()
    if local.dtype == torch.float64 and (tiles == "fast" or cuda):
        t = blocked._OzakiTiles(hoist=False)
        t.rescue = True      # a failed f32 leaf gets an f64 verdict
        return t
    return None


def _mm(t):
    return gemm_plain if t is None else t.mm


def _factor_diag(t, D):
    """(L, T, info) of the diagonal block D, which it overwrites:
    L = chol(D) and T = L⁻¹, both with a zero strict upper."""
    if t is None:
        L, info = lapack_ref.potf2(Uplo.LOWER, D)
        L = torch.tril(L)
        T, _ = lapack_ref.trti2(Uplo.LOWER, Diag.NON_UNIT, L)
    else:
        info = t.potf2(D)
        L = torch.tril(D)
        T, _ = t.trti2(L)
    return L, torch.tril(T), info


def _on_host(x):
    """A function that returns the value of the 0-d int tensor x. On the
    card the value is copied to pinned memory behind an event, so work
    enqueued after this call is not waited for when it is read."""
    if x.device.type != "cuda":
        value = int(x)
        return lambda: value
    h = torch.empty((), dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()

    def read():
        ev.synchronize()
        return int(h)
    return read


def _potrf_local(local, nb: int, group, t, lookahead: bool) -> int:
    """Factor the distributed lower matrix in place; returns info, the
    same on every rank.

    Collectives: nblk broadcasts (one diagonal per step) and nblk − 1
    all_gathers (the last step has no panel), with lookahead on or off."""
    p, r = comm.world(group), comm.rank(group)
    nlocal, _, npad = local.shape
    nblk = npad // nb
    mm = _mm(t)
    if lookahead:        # the prologue: block (0, 0)
        L, T, linfo = _factor_diag(t, diag_block(local, 0, nb, group))
        failed = _on_host(linfo)
    for j in range(nblk):
        c0, c1 = j * nb, (j + 1) * nb
        if not lookahead:
            L, T, linfo = _factor_diag(t, diag_block(local, j, nb, group))
            failed = _on_host(linfo)
        if r == j % p:
            local[j // p, :, c0:c1] = L
        bad = failed()
        if bad:
            return bad + c0
        if j + 1 == nblk:
            return 0
        # panel of my blocks past j, out of place (the product reads all
        # of its input), then stored
        l1 = first_live(j, p, r)
        k = nlocal - l1
        col = local[l1:, :, c0:c1].view(k * nb, nb)
        mine = mm(col, T.mH) if k else col.clone()
        col.copy_(mine)
        # gather from local block l0 = j // p on (zero where g <= j): the
        # rows of global blocks l0·p on, of which j+1 on are the panel
        l0 = j // p
        send = torch.zeros((nlocal - l0, nb, nb), dtype=local.dtype,
                           device=local.device)
        send[l1 - l0:] = mine.view(k, nb, nb)
        panel = torch.stack(comm.all_gather(send, group), dim=1)
        panel = panel.reshape(-1, nb)[(j + 1 - l0 * p) * nb:]
        if lookahead:
            owner = (j + 1) % p
            if r == owner:
                ln = (j + 1) // p - l1
                Pn = mine[ln * nb:(ln + 1) * nb]
                dn = mm(Pn, Pn.mH, local[(j + 1) // p, :, c1:c1 + nb],
                        alpha=-1.0, beta=1.0)
            else:
                dn = torch.empty((nb, nb), dtype=local.dtype,
                                 device=local.device)
            L, T, linfo = _factor_diag(t, comm.broadcast(dn, owner, group))
            failed = _on_host(linfo)
        if k:
            out = local[l1:, :, c1:].view(k * nb, npad - c1)
            mm(mine, panel.mH, out, alpha=-1.0, beta=1.0, out=out)
    return 0


def potrf_dist(bc: BlockCyclic, tiles: str = "auto", phases: int = 4,
               lookahead: bool = True):
    """Distributed lower Cholesky of a block-cyclic matrix. Returns
    (BlockCyclic factor, info); ``bc`` is not modified. The lower triangle
    of the logical matrix holds L; the strict upper region is left as
    it is (garbage). info is a 0-d int32 tensor on the shard's device,
    1-based and global, the same on every rank.

    tiles='auto' runs the single-device tiles (f32 on the CUDA kernels,
    f64 on the card on the d tier), 'ref' the oracle leaves, 'fast' the d
    tier for f64 anywhere. ``phases`` is kept for parity with the JAX
    signature and changes nothing: the eager loop already shrinks the
    trailing update to the live columns at every step, which the JAX
    program approximates with ``phases`` static stages, so every value of
    it gives the same result bit for bit. lookahead=True factors step
    j+1's diagonal before step j's trailing update is enqueued; False
    factors it at the top of step j+1."""
    check(isinstance(phases, int) and phases >= 1, "potrf_dist", 3,
          f"phases must be a positive int, got {phases!r}")
    local = bc.local.clone()
    t = _dist_tiles(local, bc.nb, tiles)
    info = _potrf_local(local, bc.nb, bc.group, t, lookahead)
    return (BlockCyclic(local=local, n=bc.n, nb=bc.nb, group=bc.group),
            torch.tensor(info, dtype=torch.int32, device=local.device))


def potrf_sharded(uplo, A, group=None, nb: int = 256, tiles: str = "auto",
                  phases: int = 4, lookahead: bool = True):
    """distribute → factor → collect, on a replicated A: returns the
    replicated factor and info. Upper storage is canonicalized to lower by
    conjugate transposition, as in ops/blocked.py; the opposite strict
    triangle is A's."""
    uplo = norm_uplo(uplo)
    fbc, info = potrf_dist(distribute(blocked._to_lower(A, uplo), group,
                                      nb=nb),
                           tiles=tiles, phases=phases, lookahead=lookahead)
    F = blocked._from_lower(collect(fbc), uplo)
    return blocked._merge_triangle(F, A, uplo), info


def _logdet_local(bc: BlockCyclic):
    """2·Σ log diag over my blocks (the identity pad masked), summed over
    the ranks by one all_reduce."""
    p, r = comm.world(bc.group), comm.rank(bc.group)
    local, nb = bc.local, bc.nb
    dev = local.device
    l = torch.arange(local.shape[0], device=dev)
    i = torch.arange(nb, device=dev)
    cols = (r + l[:, None] * p) * nb + i[None, :]
    d = local[l[:, None], i[None, :], cols]
    logs = torch.where(cols < bc.n, torch.log(d.real), 0.0)
    return comm.all_reduce(2.0 * logs.sum(), bc.group)


def logdet_dist(bc: BlockCyclic, tiles: str = "auto", phases: int = 4):
    """Distributed SPD log-determinant: factor, local log-diagonal sum,
    one all_reduce. Returns (value, info); the value is meaningless when
    info != 0. (The reference has no multi-GPU logdet.)"""
    fbc, info = potrf_dist(bc, tiles=tiles, phases=phases)
    return _logdet_local(fbc), info


def logdet_sharded(uplo, A, group=None, nb: int = 256):
    """distribute → factor → log-determinant, on a replicated A."""
    uplo = norm_uplo(uplo)
    return logdet_dist(distribute(blocked._to_lower(A, uplo), group, nb=nb))
