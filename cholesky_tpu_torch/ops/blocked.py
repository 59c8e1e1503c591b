"""Blocked single-device f32/f64 potrf and logdet.

The counterpart of the potrf path of ``cholesky_tpu/ops/blocked.py``: the
same halving recursion (``_potrf_lower``), the same panel solve by the
inverse of each leaf (``_trsm_rlt``), identity padding to a block-size
multiple, and upper canonicalized to lower by transposition.

Where PyTorch differs from JAX, the port works in place: ``potrf`` copies
the caller's matrix ONCE into a padded, row-major working buffer
(``_pad_identity``), and the recursion then writes L21, the updated A22
and every factor into views of that buffer, so it needs no concatenation.
The caller's tensor is never modified. ``info`` stays a 0-d int32 tensor on
the operand's device, combined with ``torch.where``: nothing inside the
recursion waits for the device.

Tile backends:
  'torch'   torch matmuls (TF32 off, see config.py) and the oracle tier's
            sweeps at the leaves: f32 and f64, any device (the CPU path).
  'cuda'    the four hand-written CUDA kernels (ops/kernels/): f32 on a
            CUDA device.
  'auto'    'cuda' for a float32 CUDA tensor, 'torch' for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.ops import kernels as _k
from cholesky_tpu_torch.ops.kernels import gemm as _gemm
from cholesky_tpu_torch.ops.kernels import mega as _mega
from cholesky_tpu_torch.ops.kernels import syrk as _syrk
from cholesky_tpu_torch.tuning import get_params
from cholesky_tpu_torch.types import Uplo, norm_uplo
from cholesky_tpu_torch.utils.errors import check

BACKENDS = ("auto", "ref", "torch", "cuda")


def _mega_ok(n: int, op: str = "potrf") -> bool:
    """Can one whole-block kernel take this block? Up to the smaller of
    the kernels' cap and the tuned ``{op}_f32.mega_max_n``, and, as in the
    JAX package, n <= NB or a multiple of NB."""
    cap = min(_mega.MAX_N, int(get_params(f"{op}_f32")["mega_max_n"]))
    return 0 < n <= cap and (n <= _mega.NB or n % _mega.NB == 0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Tile backends. Every method works on views of the working buffer:
#   mm(A, B, C=None, *, alpha, beta, out)  D = alpha·A·B + beta·C (into out)
#   syrk_ln(alpha, A, beta, C)             lower C += ..., in place
#   potf2(A) -> info                       lower factor of A, in place
#   trti2(L) -> (W, info)                  W = tril(L)⁻¹, a new tensor
# ---------------------------------------------------------------------------

class _TorchTiles:
    """Tiles over plain torch (the kernels' twins): f32 and f64, any
    device. The analog of the JAX package's ``_XlaTiles``."""
    default_nb = 128
    mm = staticmethod(_gemm.gemm_plain)
    syrk_ln = staticmethod(_syrk.syrk_lower_plain)
    potf2 = staticmethod(_mega.potrf_block_plain)
    trti2 = staticmethod(_mega.trtri_block_plain)


class _KernelTiles:
    """f32 tiles over the hand-written CUDA kernels. The analog of the JAX
    package's ``_PallasTiles``."""
    mm = staticmethod(_k.gemm_f32)
    syrk_ln = staticmethod(_k.syrk_lower_f32)

    @property
    def default_nb(self) -> int:
        return get_params("potrf_f32")["leaf_nb"]

    @staticmethod
    def _require_mega(n, op):
        if not _mega_ok(n, op):
            raise NotImplementedError(
                f"{op} of an f32 block of n={n} on the card needs the leaf "
                "kernels potf2_f32/trti2_f32 (ROADMAP Queue 2 item 7), "
                "not ported yet; use a block_size <= 128 or a multiple of "
                "128")

    def potf2(self, A):
        self._require_mega(A.shape[0], "potrf")
        return _k.potrf_block_f32(A)

    def trti2(self, L):
        self._require_mega(L.shape[0], "trtri")
        return _k.trtri_block_f32(L)


def _tiles_for(A, backend: str):
    """The tile backend for operand A, or raise for what the port does
    not run yet."""
    check(backend in BACKENDS, "blocked", 0,
          f"unknown backend {backend!r}; expected one of {BACKENDS}")
    dtype = A.dtype
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"{dtype} is not ported yet: the d tier and the c/z tier are "
            "ROADMAP Queue 1 items 9-10")
    on_cuda = A.device.type == "cuda"
    if backend == "cuda" or (backend == "auto" and on_cuda):
        check(on_cuda, "blocked", 0,
              f"backend='cuda' needs a CUDA tensor, got one on {A.device}")
        if dtype != torch.float32:
            raise NotImplementedError(
                f"{dtype} on the card is not ported yet: the d tier and "
                "the c/z tier are ROADMAP Queue 1 items 9-10")
        return _KernelTiles()
    return _TorchTiles()


# ---------------------------------------------------------------------------
# Recursive cores, in place on lower-triangular views
# ---------------------------------------------------------------------------

def _split(n: int, nb: int) -> int:
    return ((n // nb + 1) // 2) * nb


def _trsm_rlt(L, B, t, nb):
    """Solve X·Lᵀ = B in place (B := X): the potrf panel solve, by the
    inverse of each leaf of L."""
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L)
        B.copy_(t.mm(B, T.T))       # the product reads all of B: no aliasing
        return
    n1 = _split(n, nb)
    _trsm_rlt(L[:n1, :n1], B[:, :n1], t, nb)
    # B2 -= X1·Mᵀ, in place on the view B2
    B2 = B[:, n1:]
    t.mm(B[:, :n1], L[n1:, :n1].T, B2, alpha=-1.0, beta=1.0, out=B2)
    _trsm_rlt(L[n1:, n1:], B2, t, nb)


def _potrf_lower(A, t, nb, allow_mega=False):
    """Factor the lower triangle of the view A in place; returns info.
    Entries above the diagonal of A outside its diagonal leaves are left
    as they were: potrf and logdet never return them."""
    n = A.shape[0]
    # with the default block size, diagonal sub-blocks re-enter the
    # whole-block kernel as soon as they fit
    if n <= nb or (allow_mega and isinstance(t, _KernelTiles)
                   and _mega_ok(n)):
        return t.potf2(A)
    n1 = _split(n, nb)
    i1 = _potrf_lower(A[:n1, :n1], t, nb, allow_mega)
    _trsm_rlt(A[:n1, :n1], A[n1:, :n1], t, nb)
    t.syrk_ln(-1.0, A[n1:, :n1], 1.0, A[n1:, n1:])
    i2 = _potrf_lower(A[n1:, n1:], t, nb, allow_mega)
    return torch.where(i1 > 0, i1, torch.where(i2 > 0, i2 + n1, 0))


# ---------------------------------------------------------------------------
# Canonical forms: the one working copy
# ---------------------------------------------------------------------------

def _to_lower(A, uplo):
    """A view whose lower triangle holds the selected triangle of A."""
    return A.T if norm_uplo(uplo) == Uplo.UPPER else A


def _from_lower(R, uplo):
    return R.T if norm_uplo(uplo) == Uplo.UPPER else R


def _pad_identity(A, nb):
    """The working buffer: a new row-major p×p copy of A (p the next
    multiple of nb) with an identity diagonal block in the padding, which
    is exact for potrf."""
    n = A.shape[0]
    p = _round_up(max(n, nb), nb)
    W = torch.zeros((p, p), dtype=A.dtype, device=A.device)
    W[:n, :n] = A
    W.diagonal()[n:] = 1.0
    return W


def _merge_triangle(result, original, uplo):
    """The uplo triangle from result, the opposite strict triangle from
    the caller's original matrix (reference storage semantics)."""
    n = original.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=original.device)
    lower = lower.tril_() if norm_uplo(uplo) == Uplo.LOWER else lower.triu_()
    return torch.where(lower, result, original)


# ---------------------------------------------------------------------------
# Public routines
# ---------------------------------------------------------------------------

def _potrf_work(uplo, A, backend, block_size):
    """Factor a working copy of A; returns (F, info) with F an n×n view
    whose lower triangle holds the factor of the lower-form matrix."""
    n = lapack_ref._square(A, "potrf")
    t = _tiles_for(A, backend)
    if n == 0:
        return A.clone(), torch.zeros((), dtype=torch.int32,
                                      device=A.device)
    nb = block_size or t.default_nb
    W = _to_lower(A, uplo)
    # whole-matrix fast path: one kernel launch where it reaches
    if block_size is None and isinstance(t, _KernelTiles) and _mega_ok(n):
        Wp = _pad_identity(W, n)
        return Wp, t.potf2(Wp)
    Wp = _pad_identity(W, nb)
    info = _potrf_lower(Wp, t, nb, allow_mega=block_size is None)
    return Wp[:n, :n], info


def potrf(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Blocked Cholesky (reference cuSpotrf, lapack/spotrf.c:261-398).
    Returns (A_factored, info); A itself is not modified. The opposite
    strict triangle is the caller's."""
    uplo = norm_uplo(uplo)
    if backend == "ref":
        return lapack_ref.potrf(uplo, A)
    F, info = _potrf_work(uplo, A, backend, block_size)
    return _merge_triangle(_from_lower(F, uplo), A, uplo), info


def logdet(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """SPD log-determinant: blocked potrf + log-diagonal sum. Returns
    (value, info); the value is meaningless when info != 0."""
    uplo = norm_uplo(uplo)
    if backend == "ref":
        return lapack_ref.logdet(uplo, A)
    F, info = _potrf_work(uplo, A, backend, block_size)
    return lapack_ref.logdet_from_factor(F), info
