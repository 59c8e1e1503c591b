"""Blocked single-device potrf, potf2, logdet, trtri, lauum, potri and the
Level-3 BLAS (gemm, syrk, herk, trmm, trsm) in all four precisions.

The counterpart of ``cholesky_tpu/ops/blocked.py`` for these routines: the
same halving recursions (``_potrf_lower``, ``_trtri_lower``,
``_lauum_lower``, ``_trsm_lln``/``_trsm_llt``, ``_trmm_lln_tiles``), the
same solves by the inverse of each leaf, identity padding to a block-size
multiple, and upper (and right-side) cases canonicalized to lower-left by
conjugate transposition (and, for trmm, by reversal).

Where PyTorch differs from JAX, the port works in place: each routine
copies the caller's matrix ONCE into a row-major working buffer
(``_working_copy``, padded with identity where the recursion needs it),
and the recursion then writes every block of the result into views of
that buffer, so it needs no concatenation. The caller's tensors are never
modified. ``info`` stays a 0-d int32 tensor on
the operand's device, combined with ``torch.where``: nothing inside the
recursion waits for the device.

Tile backends:
  'torch'   torch matmuls (TF32 off, see config.py) and the oracle tier's
            sweeps at the leaves: every dtype, complex natively, any
            device (the CPU path).
  'cuda'    the hand-written CUDA kernels (ops/kernels/): f32 on a CUDA
            device.
  'ozaki'   the d tier: f64 products as exact int8 slice products
            (ops/ozaki.py), leaves by the f32 kernels plus one refinement
            step; the kernels on a CUDA device, their twins on the CPU.
  'embed'   complex operands through the interleaved real embedding
            (ops/complex_embed.py) onto the real tiles at twice the size,
            which run under 'auto'.
  'auto'    'cuda' for a float32 CUDA tensor, 'ozaki' for a float64 CUDA
            tensor, 'embed' for a complex CUDA tensor (as the JAX package
            on its accelerator), 'torch' for a CPU tensor.
An (re, im) pair of real planes always takes the embedding, as in the
JAX package (``_route_complex``). The BLAS wrappers send a complex tensor
that is not embedded to the oracle (blas_ref), as JAX does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops import blas_ref, lapack_ref, ozaki
from cholesky_tpu_torch.ops import kernels as _k
from cholesky_tpu_torch.ops.kernels import gemm as _gemm
from cholesky_tpu_torch.ops.kernels import leaf as _leaf
from cholesky_tpu_torch.ops.kernels import mega as _mega
from cholesky_tpu_torch.ops.kernels import syrk as _syrk
from cholesky_tpu_torch.tuning import get_params
from cholesky_tpu_torch.types import (Diag, Side, Trans, Uplo, norm_diag,
                                      norm_side, norm_trans, norm_uplo)
from cholesky_tpu_torch.utils import profiling
from cholesky_tpu_torch.utils.errors import check

BACKENDS = ("auto", "ref", "torch", "cuda", "ozaki", "embed")

def _mega_ok(n: int, op: str = "potrf") -> bool:
    """Can one whole-matrix kernel take this block? As in the JAX package
    (``blocked.py:56-71``): up to MAX_N (1024) a *_block_f32 kernel takes
    any n <= NB or multiple of NB, whatever the tuned cap; above it, a
    multiple of NB up to the smaller of the *_stream_f32 kernels' cap and
    the tuned ``{op}_f32.mega_max_n``."""
    if n <= _mega.MAX_N:
        return 0 < n and (n <= _mega.NB or n % _mega.NB == 0)
    cap = min(_mega.STREAM_MAX_N, int(get_params(f"{op}_f32").get(
        "mega_max_n", _mega.STREAM_MAX_N)))
    return n <= cap and n % _mega.NB == 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Force the d tier's hoisted-peel recursions on (True) or off (False)
# whatever the size, for tests and A/B runs; None: _ozaki_hoist decides per
# driver call.
_OZAKI_HOIST_OVERRIDE: Optional[bool] = None


def _ozaki_hoist(n: Optional[int], op: str = "potrf") -> bool:
    """Should this driver call use the hoisted-peel recursions
    (_OzakiTiles.trsm_*/trtri_lower and the single-peel syrk_ln)? From
    n >= ``ozaki_f64.hoist_min_n`` (per op: ``hoist_min_n_<op>``), as in
    the JAX package, whose threshold came from an A/B on a TPU."""
    if _OZAKI_HOIST_OVERRIDE is not None:
        return bool(_OZAKI_HOIST_OVERRIDE)
    if n is None:
        return True
    p = get_params("ozaki_f64")
    return n >= int(p.get(f"hoist_min_n_{op}", p.get("hoist_min_n", 0)))


# ---------------------------------------------------------------------------
# Tile backends. Every method works on views of the working buffer:
#   mm(A, B, C=None, *, alpha, beta, out)  D = alpha·A·B + beta·C (into out)
#   syrk_ln(alpha, A, beta, C)             lower C += alpha·A·Aᴴ + ...,
#                                          in place
#   potf2(A) -> info                       lower factor of A, in place
#   trti2(L, unit) -> (W, info)            W = tril(L)⁻¹, a new tensor
#   lauu2(L) -> B                          tril(LᴴL) below, L's strict
#                                          upper above, a new tensor
# Only the torch tile sees complex operands (and lazy conj views, which
# torch's matmul reads as they are); the kernel tiles see real tensors.
# ---------------------------------------------------------------------------

class _TorchTiles:
    """Tiles over plain torch (the kernels' twins and the oracle tier):
    every dtype, complex natively, any device. The analog of the JAX
    package's ``_XlaTiles``."""
    default_nb = 128
    mm = staticmethod(_gemm.gemm_plain)
    syrk_ln = staticmethod(_syrk.syrk_lower_plain)
    potf2 = staticmethod(_mega.potrf_block_plain)
    # the oracle's: a Hermitian product has an exactly real diagonal
    lauu2 = staticmethod(functools.partial(lapack_ref.lauu2, Uplo.LOWER))

    trti2 = staticmethod(_leaf.trti2_plain)


class _KernelTiles:
    """f32 tiles over the hand-written CUDA kernels. The analog of the JAX
    package's ``_PallasTiles``."""
    mm = staticmethod(_k.gemm_f32)
    syrk_ln = staticmethod(_k.syrk_lower_f32)

    @property
    def default_nb(self) -> int:
        return get_params("potrf_f32")["leaf_nb"]

    @staticmethod
    def potf2(A):
        """One whole-matrix kernel where _mega_ok takes the block
        (potrf_stream_f32 for the multiples of 128 from
        POTRF_STREAM_MIN_N, potrf_block_f32 for the rest up to 1024), the
        leaf kernel potf2_f32 elsewhere (JAX ``_PallasTiles.potf2``)."""
        n = A.shape[0]
        if not _mega_ok(n):
            return _k.potf2_f32(A)
        stream = n > _mega.MAX_N or (n % _mega.NB == 0
                                     and n >= _mega.POTRF_STREAM_MIN_N)
        return (_k.potrf_stream_f32 if stream else _k.potrf_block_f32)(A)

    @staticmethod
    def trti2(L, unit=False):
        """One whole-matrix kernel where _mega_ok takes the block
        (trtri_block_f32 up to 1024, then trtri_stream_f32), the leaf
        kernel trti2_f32 elsewhere (JAX ``_PallasTiles.trti2``)."""
        n = L.shape[0]
        if not _mega_ok(n, "trtri"):
            return _k.trti2_f32(L, unit=unit)
        kern = _k.trtri_block_f32 if n <= _mega.MAX_N else _k.trtri_stream_f32
        return _leaf.unit_inverse(kern, L) if unit else kern(L)

    lauu2 = staticmethod(_k.lauu2_f32)


def _ozaki_leaf(name):
    """The span ``ozaki.<name>`` of an _OzakiTiles leaf method, its
    attribute the block's order: potf2's and trti2's f32 kernel and its
    correction step, lauu2's one Ozaki product."""
    return profiling.annotate_function(
        name=f"ozaki.{name}",
        attrs=lambda self, X, *args, **kwargs: {"n": X.shape[0]})


class _OzakiTiles:
    """f64 tiles whose products are exact int8 slice products (ops/
    ozaki.py): the d tier, the analog of the JAX package's ``_OzakiTiles``
    (``blocked.py:215-494``).

    The leaves are factored or inverted by the f32 kernels and promoted by
    ONE correction step of Ozaki products, which squares the f32 error
    (about 2^-24 to 2^-48):
      potf2:  L = Lh + Lh·Φ(Lh⁻¹ R Lh⁻ᵀ),  R = A − Lh·Lhᵀ,
              Φ = strict lower + ½ diagonal
      trti2:  one Newton step W1 = W0·(2I − L·W0)
    slices = 6 gives products near 2^-42. A pivot fails at f32 precision;
    with ``rescue`` set, a leaf whose f32 factor fails is factored again
    by the f64 oracle, so that info is an f64 verdict (``_potrf_work``
    sets it only for a second pass, after a first one reported info > 0).
    Each leaf is the span ``ozaki.potf2``, ``ozaki.trti2`` or
    ``ozaki.lauu2``, and the second pass ``ozaki.rescue``.
    """
    default_nb = 128
    slices = 6

    def __init__(self, hoist: bool = True):
        # the hoisted-peel recursions below and the single-peel syrk_ln,
        # chosen per driver call (_ozaki_hoist)
        self.hoist = hoist
        self.rescue = False

    def _mm(self, A, B, **update):
        return ozaki.matmul_f64(A, B, slices=self.slices, **update)

    def _split(self, X):
        return ozaki.split_rows(X, self.slices)

    def mm(self, A, B, C=None, *, alpha=1.0, beta=0.0, out=None):
        # the update runs inside the product where it reads only out
        if C is None or beta == 0.0:
            return self._mm(A, B, out=out, alpha=alpha)
        if C is out:
            return self._mm(A, B, out=out, alpha=alpha, beta=beta)
        D = self._mm(A, B, alpha=alpha) + beta * C
        return D if out is None else out.copy_(D)

    def syrk_ln(self, alpha, A, beta, C):
        """C := alpha·A·Aᵀ + beta·C in place, the whole square (only the
        lower triangle is read later). Hoisted: ONE peel of A serves both
        sides of the product."""
        if not self.hoist:
            self.mm(A, A.T, C, alpha=alpha, beta=beta, out=C)
            return
        As, asc = self._split(A)
        ozaki.matmul_presplit(As, asc, As, asc, out=C, alpha=alpha, beta=beta)

    @_ozaki_leaf("potf2")
    def potf2(self, A):
        """Factor the lower triangle of the f64 block A in place (strict
        upper zeroed); returns info."""
        L32 = A.to(torch.float32, memory_format=torch.contiguous_format)
        info = _KernelTiles().potf2(L32)
        # past a failed pivot the f32 factor leaves raw values (<= 0) on
        # the diagonal: set them to 1 before the solves divide by them
        # (the leading info-1 block is exact either way)
        d32 = L32.diagonal()
        d32.copy_(torch.where(d32 > 0, d32, 1.0))
        Lh = L32.double()
        # R is the full symmetric residual; only A's lower triangle is valid
        Afull = torch.tril(A) + torch.tril(A, -1).T
        R32 = (Afull - self._mm(Lh, Lh.T)).float()
        # G = Lh⁻¹·R·Lh⁻ᵀ in f32: R is already about 2^-24·|A|
        G32 = torch.linalg.solve_triangular(L32, R32, upper=False)
        G32 = torch.linalg.solve_triangular(L32, G32.T, upper=False).T
        Phi = torch.tril(G32, -1) + 0.5 * torch.diag(torch.diagonal(G32))
        refined = torch.tril(Lh + (L32 @ Phi).double())
        if self.rescue and int(info) > 0:
            F64, info = lapack_ref.potf2("L", A)
            refined = torch.tril(F64)
        A.copy_(refined)
        return info

    @_ozaki_leaf("trti2")
    def trti2(self, L, unit=False):
        """(W, info): the inverse of the lower-triangular f64 block L by
        the f32 kernel and one Newton step."""
        n = L.shape[0]
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        W32, info = _KernelTiles().trti2(
            L.to(torch.float32, memory_format=torch.contiguous_format),
            unit=unit)
        W0 = W32.double()
        if unit:
            W0 = torch.tril(W0, -1) + eye
        Lm = torch.tril(L, -1) + (eye if unit else torch.diag(
            torch.diagonal(L)))
        D = 2.0 * eye - self._mm(Lm, W0)
        W1 = torch.tril(self._mm(W0, D))
        if unit:
            # LAPACK: a unit diagonal passes through untouched
            W1 = torch.tril(W1, -1) + torch.diag(torch.diagonal(L))
        return W1, info

    @_ozaki_leaf("lauu2")
    def lauu2(self, L):
        T = torch.tril(L)
        return torch.tril(self._mm(T.T, T)) + torch.triu(L, 1)

    # The hoisted recursions: the factor-side operand of every
    # off-diagonal update is a sub-block of ONE peel of the whole
    # triangle, with the row scales of its full rows (a sub-block of a
    # peel is an exact peel; only the dropped-pair bound loosens from the
    # block's max to the row's). In place on B (or L), as the generic
    # recursions.

    def trsm_rlt(self, L, B, nb):
        """X·Lᵀ = B in place (the potrf panel solve)."""
        Lt = torch.tril(L)
        Ls, lsc = self._split(Lt)

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n])
                self._mm(B, T.T, out=B)
                return
            n1 = _split(n, nb)
            rec(i, n1, B[:, :n1])
            Xs, xsc = self._split(B[:, :n1])
            ozaki.matmul_presplit(
                Xs, xsc, Ls[:, i + n1:i + n, i:i + n1], lsc[i + n1:i + n],
                out=B[:, n1:], alpha=-1.0, beta=1.0)
            rec(i + n1, n - n1, B[:, n1:])

        rec(0, L.shape[0], B)
        del rec   # rec holds itself: free the peel now, not at a collection

    def trsm_lln(self, L, B, nb, unit):
        """L·X = B in place, forward."""
        Lt = torch.tril(L)
        Ls, lsc = self._split(Lt)

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n], unit=unit)
                if unit:
                    T = _force_unit_diag(T)
                self._mm(T, B, out=B)
                return
            n1 = _split(n, nb)
            rec(i, n1, B[:n1])
            Xs, xsc = self._split(B[:n1].T)
            ozaki.matmul_presplit(
                Ls[:, i + n1:i + n, i:i + n1], lsc[i + n1:i + n], Xs, xsc,
                out=B[n1:], alpha=-1.0, beta=1.0)
            rec(i + n1, n - n1, B[n1:])

        rec(0, L.shape[0], B)
        del rec   # rec holds itself: free the peel now, not at a collection

    def trsm_llt(self, L, B, nb, unit):
        """Lᵀ·X = B in place, backward; the hoisted peel is that of Lᵀ."""
        Lt = torch.tril(L)
        LTs, ltsc = self._split(Lt.T)

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n], unit=unit)
                if unit:
                    T = _force_unit_diag(T)
                self._mm(T.T, B, out=B)
                return
            n1 = _split(n, nb)
            rec(i + n1, n - n1, B[n1:])
            Xs, xsc = self._split(B[n1:].T)
            ozaki.matmul_presplit(
                LTs[:, i:i + n1, i + n1:i + n], ltsc[i:i + n1], Xs, xsc,
                out=B[:n1], alpha=-1.0, beta=1.0)
            rec(i, n1, B[:n1])

        rec(0, L.shape[0], B)
        del rec   # rec holds itself: free the peel now, not at a collection

    def trtri_lower(self, L, nb, unit):
        """Invert the lower-triangular view L in place; returns info. The
        update M' = −W2·M·W1 reads M = L[2,1] through one peel of Lᵀ,
        taken before anything is overwritten."""
        Lt = torch.tril(L)
        LTs, ltsc = self._split(Lt.T)

        def rec(i, n):
            if n <= nb:
                W, info = self.trti2(Lt[i:i + n, i:i + n], unit=unit)
                L[i:i + n, i:i + n] = W
                return info
            n1 = _split(n, nb)
            i1 = rec(i, n1)
            i2 = rec(i + n1, n - n1)
            W1 = L[i:i + n1, i:i + n1]
            W2 = L[i + n1:i + n, i + n1:i + n]
            W1e = _force_unit_diag(W1) if unit else W1
            W2e = _force_unit_diag(W2) if unit else W2
            Ws, wsc = self._split(W2e)
            P = ozaki.matmul_presplit(
                Ws, wsc, LTs[:, i:i + n1, i + n1:i + n], ltsc[i:i + n1])
            self.mm(P, W1e, alpha=-1.0, out=L[i + n1:i + n, i:i + n1])
            return torch.where(i1 > 0, i1, torch.where(i2 > 0, i2 + n1, 0))

        info = rec(0, L.shape[0])
        del rec   # rec holds itself: free the peel now, not at a collection
        return info

    def trmm_lln(self, L, B, nb):
        """L·B, L exactly lower triangular, by the live-block recursion
        with ONE peel of L and one of Bᵀ shared by every block product (JAX
        ``blocked.py:466-494``). A ragged tail up to 1.5·nb is absorbed
        into one leaf. Returns a new tensor."""
        Ls, lsc = self._split(L)
        Bs, bsc = self._split(B.T)
        out = torch.empty((L.shape[0], B.shape[1]), dtype=L.dtype,
                          device=L.device)

        def rec(i, n):
            C = out[i:i + n]
            if n <= nb + nb // 2:
                ozaki.matmul_presplit(
                    Ls[:, i:i + n, i:i + n], lsc[i:i + n],
                    Bs[:, :, i:i + n], bsc, out=C)
                return
            n1 = _split(n, nb)
            rec(i, n1)
            rec(i + n1, n - n1)
            ozaki.matmul_presplit(
                Ls[:, i + n1:i + n, i:i + n1], lsc[i + n1:i + n],
                Bs[:, :, i:i + n1], bsc, out=C[n1:], beta=1.0)

        rec(0, L.shape[0])
        del rec   # rec holds itself: free the peels now, not at a collection
        return out


def _route_complex(A, backend: str) -> bool:
    """Does this operand go through the real embedding
    (ops/complex_embed.py)? As the JAX package's ``_route_complex``
    (``blocked.py:497-518``): an (re, im) pair always; a complex tensor
    under 'embed', and under 'auto' on a CUDA device, the port's
    accelerator. A complex CPU tensor under 'auto' takes the torch tile
    natively. Also rejects an unknown backend name."""
    check(backend in BACKENDS, "blocked", 0,
          f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if isinstance(A, tuple):
        return True
    if not A.is_complex():
        return False
    return backend == "embed" or (backend == "auto"
                                  and A.device.type == "cuda")


def _embed_backend(backend: str) -> str:
    """The real planes' backend inside the embedding: 'embed' (or 'auto')
    runs them under 'auto'; any other explicit backend is honored."""
    return "auto" if backend in ("auto", "embed") else backend


def _embedding():
    """ops/complex_embed.py, imported on first use: it imports this
    module."""
    from cholesky_tpu_torch.ops import complex_embed
    return complex_embed


def _tiles_for(A, backend: str, n: Optional[int] = None,
               op: str = "potrf"):
    """The tile backend for operand A of a driver call on an n×n matrix,
    or raise for what the port does not run yet."""
    check(backend in BACKENDS, "blocked", 0,
          f"unknown backend {backend!r}; expected one of {BACKENDS}")
    check(backend != "embed", "blocked", 0,
          "backend='embed' requires complex operands (tensors or (re, im) "
          "pairs)")
    dtype = A.dtype
    on_cuda = A.device.type == "cuda"
    if backend == "ozaki" or (backend == "auto" and on_cuda
                              and dtype == torch.float64):
        check(dtype == torch.float64, "blocked", 0,
              f"ozaki backend supports float64 only, got {dtype}")
        return _OzakiTiles(hoist=_ozaki_hoist(n, op))
    if backend == "cuda" or (backend == "auto" and on_cuda):
        check(on_cuda, "blocked", 0,
              f"backend='cuda' needs a CUDA tensor, got one on {A.device}")
        check(dtype == torch.float32, "blocked", 0,
              f"cuda backend supports float32 only, got {dtype}; float64 "
              "on the card is backend='ozaki' (or 'auto')")
        return _KernelTiles()
    return _TorchTiles()


# ---------------------------------------------------------------------------
# Recursive cores, in place on lower-triangular views
# ---------------------------------------------------------------------------

def _split(n: int, nb: int) -> int:
    return ((n // nb + 1) // 2) * nb


def _trsm_rlt(L, B, t, nb):
    """Solve X·Lᴴ = B in place (B := X): the potrf panel solve, by the
    inverse of each leaf of L (Lᴴ is Lᵀ for a real L)."""
    if getattr(t, "hoist", False):          # the d tier's hoisted peel
        return t.trsm_rlt(L, B, nb)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L)
        B.copy_(t.mm(B, T.mH))      # the product reads all of B: no aliasing
        return
    n1 = _split(n, nb)
    _trsm_rlt(L[:n1, :n1], B[:, :n1], t, nb)
    # B2 -= X1·Mᴴ, in place on the view B2
    B2 = B[:, n1:]
    t.mm(B[:, :n1], L[n1:, :n1].mH, B2, alpha=-1.0, beta=1.0, out=B2)
    _trsm_rlt(L[n1:, n1:], B2, t, nb)


def _force_unit_diag(T):
    return T - torch.diag(torch.diagonal(T)) + torch.eye(
        T.shape[0], dtype=T.dtype, device=T.device)


def _trsm_lln(L, B, t, nb, unit):
    """Solve L·X = B in place (B := X), left, lower, no transpose."""
    if getattr(t, "hoist", False):
        return t.trsm_lln(L, B, nb, unit)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L, unit=unit)
        if unit:
            T = _force_unit_diag(T)
        B.copy_(t.mm(T, B))         # the product reads all of B
        return
    n1 = _split(n, nb)
    _trsm_lln(L[:n1, :n1], B[:n1], t, nb, unit)
    B2 = B[n1:]                     # B2 -= M·X1, in place
    t.mm(L[n1:, :n1], B[:n1], B2, alpha=-1.0, beta=1.0, out=B2)
    _trsm_lln(L[n1:, n1:], B2, t, nb, unit)


def _trsm_llt(L, B, t, nb, unit):
    """Solve Lᵀ·X = B in place (B := X), left, lower, transposed."""
    if getattr(t, "hoist", False):
        return t.trsm_llt(L, B, nb, unit)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L, unit=unit)
        if unit:
            T = _force_unit_diag(T)
        B.copy_(t.mm(T.T, B))
        return
    n1 = _split(n, nb)
    _trsm_llt(L[n1:, n1:], B[n1:], t, nb, unit)
    B1 = B[:n1]                     # B1 -= Mᵀ·X2, in place
    t.mm(L[n1:, :n1].T, B[n1:], B1, alpha=-1.0, beta=1.0, out=B1)
    _trsm_llt(L[:n1, :n1], B1, t, nb, unit)


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


def _trtri_lower(L, t, nb, unit, allow_mega=False):
    """Invert the lower-triangular view L in place; returns info. The
    strict upper of L must be zero: the off-diagonal products read the
    inverted diagonal blocks whole."""
    if getattr(t, "hoist", False):
        return t.trtri_lower(L, nb, unit)
    n = L.shape[0]
    # with the default block size, diagonal sub-blocks re-enter the
    # whole-matrix kernels as soon as they fit (see _potrf_lower)
    if n <= nb or (allow_mega and isinstance(t, _KernelTiles)
                   and _mega_ok(n, "trtri")):
        W, info = t.trti2(L, unit=unit)
        L.copy_(W)
        return info
    n1 = _split(n, nb)
    i1 = _trtri_lower(L[:n1, :n1], t, nb, unit, allow_mega)
    i2 = _trtri_lower(L[n1:, n1:], t, nb, unit, allow_mega)
    W1, W2 = L[:n1, :n1], L[n1:, n1:]
    W1e = _force_unit_diag(W1) if unit else W1
    W2e = _force_unit_diag(W2) if unit else W2
    # M' = -W2·M·W1 (reference strtri.c column update, collapsed)
    Mp = t.mm(W2e, L[n1:, :n1])
    t.mm(Mp, W1e, alpha=-1.0, out=L[n1:, :n1])
    return torch.where(i1 > 0, i1, torch.where(i2 > 0, i2 + n1, 0))


def _lauum_lower(L, t, nb, allow_mega=False):
    """tril(LᴴL) of the lower triangle of the view L, in place; the strict
    upper of L is never read."""
    n = L.shape[0]
    if n <= nb:
        L.copy_(t.lauu2(L))
        return
    # the whole-diagonal route (JAX blocked.py:678-680): the kernel is out
    # of place, so its result is copied back into the view
    if (allow_mega and isinstance(t, _KernelTiles) and n % _mega.NB == 0
            and _mega_ok(n, "lauum")):
        L.copy_(_k.lauum_stream_f32(L))
        return
    n1 = _split(n, nb)
    L1, M, L2 = L[:n1, :n1], L[n1:, :n1], L[n1:, n1:]
    B21 = t.mm(torch.tril(L2).mH, M)        # L2ᴴ·M, before L2 is squared
    _lauum_lower(L1, t, nb, allow_mega)
    t.syrk_ln(1.0, M.mH, 1.0, L1)           # B11 += MᴴM
    _lauum_lower(L2, t, nb, allow_mega)
    M.copy_(B21)


# the recursions' top-level calls, each the span driver.<name>; inside, the
# recursions call themselves unspanned
_potrf_driver = profiling.annotate_function(_potrf_lower, "driver.potrf_lower")
_trtri_driver = profiling.annotate_function(_trtri_lower, "driver.trtri_lower")
_lauum_driver = profiling.annotate_function(_lauum_lower, "driver.lauum_lower")
_trsm_lln_driver = profiling.annotate_function(_trsm_lln, "driver.trsm_lln")
_trsm_llt_driver = profiling.annotate_function(_trsm_llt, "driver.trsm_llt")


# ---------------------------------------------------------------------------
# Canonical forms: the one working copy
# ---------------------------------------------------------------------------

def _to_lower(A, uplo):
    """A view whose lower triangle holds the selected triangle of A,
    conjugated for upper (a lazy conj view for a complex A: the working
    copy resolves it)."""
    return A.mH if norm_uplo(uplo) == Uplo.UPPER else A


def _from_lower(R, uplo):
    return R.mH if norm_uplo(uplo) == Uplo.UPPER else R


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


@profiling.annotate_function(name="blocked.copy_in")
def _working_copy(A, t, nb, op, allow_mega):
    """The working buffer of a routine: padded to a multiple of nb for the
    recursion, or not padded at all when one whole-matrix kernel takes the
    matrix (the recursion's top-level call then launches it)."""
    n = A.shape[0]
    whole = allow_mega and isinstance(t, _KernelTiles) and _mega_ok(n, op)
    return _pad_identity(A, n if whole else nb)


def _merge_triangle(result, original, uplo):
    """The uplo triangle from result, the opposite strict triangle from
    the caller's original matrix (reference storage semantics)."""
    n = original.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=original.device)
    lower = lower.tril_() if norm_uplo(uplo) == Uplo.LOWER else lower.triu_()
    return torch.where(lower, result, original)


@profiling.annotate_function(name="blocked.copy_in")
def _solve_copy(A, B, alpha, nb, unit):
    """The working copies of a left lower solve: A padded with identity
    to a multiple of nb, its diagonal 1 where ``unit`` (only the lower
    triangle is read, so the recursion runs non-unit), and alpha·B over
    zero rows."""
    Lp = _pad_identity(A, nb)
    if unit:
        Lp.diagonal().fill_(1.0)
    Bp = torch.zeros((Lp.shape[0], B.shape[1]), dtype=B.dtype,
                     device=B.device)
    Bp[:A.shape[0]] = B if alpha == 1.0 else alpha * B
    return Lp, Bp


@profiling.annotate_function(name="blocked.copy_out")
def _copy_out(R, original, uplo):
    """A routine's result: the uplo triangle from the lower-form result
    R, the opposite strict triangle from the caller's original."""
    return _merge_triangle(_from_lower(R, uplo), original, uplo)


# ---------------------------------------------------------------------------
# Public routines
# ---------------------------------------------------------------------------

def _potrf_work(uplo, A, backend, block_size):
    """Factor a working copy of A; returns (F, info) with F an n×n view
    whose lower triangle holds the factor of the lower-form matrix.

    On the d tier a pivot fails at f32 precision. Where the JAX package
    re-factors each failing leaf in f64 inside the run (a lax.cond), this
    reads info once per call: for a positive-definite input that is the
    one wait for the device. Only when it is > 0 does it factor again from
    A, now with the f64 rescue on every failing leaf, which gives the JAX
    package's verdict."""
    n = lapack_ref._square(A, "potrf")
    t = _tiles_for(A, backend, n)
    if n == 0:
        return A.clone(), torch.zeros((), dtype=torch.int32,
                                      device=A.device)
    nb = block_size or t.default_nb
    allow_mega = block_size is None
    Wp = _working_copy(_to_lower(A, uplo), t, nb, "potrf", allow_mega)
    info = _potrf_driver(Wp, t, nb, allow_mega)
    if isinstance(t, _OzakiTiles) and int(info) > 0:
        with profiling.annotate("ozaki.rescue"):
            t.rescue = True
            Wp = _working_copy(_to_lower(A, uplo), t, nb, "potrf",
                               allow_mega)
            info = _potrf_driver(Wp, t, nb, allow_mega)
    return Wp[:n, :n], info


def potrf(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Blocked Cholesky (reference cuSpotrf, lapack/spotrf.c:261-398).
    Returns (A_factored, info); A itself is not modified. The opposite
    strict triangle is the caller's. A complex operand the embedding
    takes (``_route_complex``) factors there: c64 on the f32 tiles, c128
    on the d tier, a pair in and a pair out."""
    if _route_complex(A, backend):
        return _embedding().potrf_split(uplo, A,
                                        backend=_embed_backend(backend),
                                        block_size=block_size)
    uplo = norm_uplo(uplo)
    if backend == "ref":
        return lapack_ref.potrf(uplo, A)
    F, info = _potrf_work(uplo, A, backend, block_size)
    return _copy_out(F, A, uplo), info


def logdet(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """SPD (HPD) log-determinant: blocked potrf + log-diagonal sum.
    Returns (value, info); the value is meaningless when info != 0."""
    if _route_complex(A, backend):
        return _embedding().logdet_split(uplo, A,
                                         backend=_embed_backend(backend),
                                         block_size=block_size)
    uplo = norm_uplo(uplo)
    if backend == "ref":
        return lapack_ref.logdet(uplo, A)
    F, info = _potrf_work(uplo, A, backend, block_size)
    return lapack_ref.logdet_from_factor(F), info


def potf2(uplo, A, backend: str = "auto"):
    """Unblocked Cholesky of one diagonal block (JAX ``blocked.py:773-790``).
    An f32 block on the card of n <= 128 or a multiple of 128 goes to one
    kernel: the whole-matrix kernel where it fits, potf2_f32 above it
    (``_KernelTiles.potf2``); anything else to the oracle sweep. Returns
    (A_factored, info); A itself is not modified, the opposite strict
    triangle is the caller's. A complex operand the embedding takes
    factors there, as in the JAX package."""
    if _route_complex(A, backend):
        return _embedding().potrf_split(uplo, A,
                                        backend=_embed_backend(backend))
    u = norm_uplo(uplo)
    n = lapack_ref._square(A, "potf2")
    if backend == "ref":
        return lapack_ref.potf2(u, A)
    t = _tiles_for(A, backend, n)
    if isinstance(t, _KernelTiles) and 0 < n and (
            n <= _mega.NB or n % _mega.NB == 0):
        W = _to_lower(A, u).clone(memory_format=torch.contiguous_format)
        info = t.potf2(W)
        return _copy_out(W, A, u), info
    return lapack_ref.potf2(u, A)


def trti2(uplo, diag, A, backend: str = "auto"):
    """Unblocked triangular inverse of one block: the oracle sweep, as in
    the JAX package; a complex operand the embedding takes is inverted
    there. Returns (A_inv, info)."""
    if _route_complex(A, backend):
        return _embedding().trtri_split(uplo, diag, A,
                                        backend=_embed_backend(backend))
    return lapack_ref.trti2(uplo, diag, A)


def lauu2(uplo, A, backend: str = "auto"):
    """Unblocked triangular square of one block: the oracle, as in the JAX
    package; complex routing as in :func:`trti2`."""
    if _route_complex(A, backend):
        return _embedding().lauum_split(uplo, A,
                                        backend=_embed_backend(backend))
    return lapack_ref.lauu2(uplo, A)


def trtri(uplo, diag, A, backend: str = "auto",
          block_size: Optional[int] = None):
    """Blocked triangular inverse (reference cuStrtri, strtri.c:369-472).
    Returns (A_inv, info); A itself is not modified. A zero diagonal sets
    info and is read as 1. With diag='U' the diagonal passes through
    (every leaf puts it back, ``kernels.leaf.unit_inverse``). Complex
    routing as in :func:`potrf`."""
    if _route_complex(A, backend):
        return _embedding().trtri_split(uplo, diag, A,
                                        backend=_embed_backend(backend),
                                        block_size=block_size)
    uplo = norm_uplo(uplo)
    unit = norm_diag(diag) == Diag.UNIT
    n = lapack_ref._square(A, "trtri")
    if backend == "ref":
        return lapack_ref.trtri(uplo, diag, A)
    t = _tiles_for(A, backend, n, "trtri")
    if n == 0:
        return A.clone(), torch.zeros((), dtype=torch.int32,
                                      device=A.device)
    nb = block_size or t.default_nb
    allow_mega = block_size is None
    # the recursion reads whole inverted blocks: the strict upper of the
    # working copy is cleared
    Wp = _working_copy(_to_lower(A, uplo), t, nb, "trtri", allow_mega)
    Wp.tril_()
    info = _trtri_driver(Wp, t, nb, unit, allow_mega)
    return _copy_out(Wp[:n, :n], A, uplo), info


def trtri2(uplo, diag, A, backend: str = "auto",
           block_size: Optional[int] = None):
    """Out-of-place variant (reference strtri2): every routine here is out
    of place, so it is :func:`trtri`."""
    return trtri(uplo, diag, A, backend=backend, block_size=block_size)


def lauum(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Blocked triangular square (reference cuSlauum, slauum.c:197-305):
    Lᴴ·L (lower) or U·Uᴴ (upper) in the uplo triangle, the opposite strict
    triangle the caller's. A itself is not modified. Complex routing as in
    :func:`potrf`."""
    if _route_complex(A, backend):
        return _embedding().lauum_split(uplo, A,
                                        backend=_embed_backend(backend),
                                        block_size=block_size)
    uplo = norm_uplo(uplo)
    n = lapack_ref._square(A, "lauum")
    if backend == "ref":
        return lapack_ref.lauum(uplo, A)
    t = _tiles_for(A, backend, n, "lauum")
    if n == 0:
        return A.clone()
    nb = block_size or t.default_nb
    allow_mega = block_size is None
    Wp = _working_copy(_to_lower(A, uplo), t, nb, "lauum", allow_mega)
    _lauum_driver(Wp, t, nb, allow_mega)
    return _copy_out(Wp[:n, :n], A, uplo)


def potri(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """SPD (HPD) inverse from the Cholesky factor: trtri then lauum, the
    pure composition of every tier of the reference (spotri.c). Returns
    (A_inv, info), the inverse in the uplo triangle."""
    W, info = trtri(uplo, Diag.NON_UNIT, A, backend=backend,
                    block_size=block_size)
    return lauum(uplo, W, backend=backend, block_size=block_size), info


# ---------------------------------------------------------------------------
# BLAS (JAX blocked.py:897-1161): backend='ref' takes the oracle (blas_ref),
# and so do a complex tensor the embedding does not take and a CPU operand
# with a scalar that is not a Python number
# ---------------------------------------------------------------------------

def _static_scalar(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _static_scalar_cx(x) -> bool:
    """A Python number for the embedding tier: complex allowed (the
    reference's c/z BLAS takes complex alpha and beta)."""
    return isinstance(x, (int, float, complex)) and not isinstance(x, bool)


def _embed_scalars_ok(A, scalars, real: bool = False) -> bool:
    """May the embedding tier read these scalars? Python numbers (complex
    unless ``real``), or anything on the card, where a 0-d tensor is read
    with complex() or float() as the real wrappers read it; JAX sends a
    traced scalar away from the embedding."""
    static = _static_scalar if real else _static_scalar_cx
    plane = A[0] if isinstance(A, tuple) else A
    return all(map(static, scalars)) or plane.device.type == "cuda"


def _check_no_stray_pairs(name, *operands):
    """A pair operand the embedding did not take (a scalar it may not
    read) fails with an xerbla-style error, as in the JAX package."""
    for X in operands:
        check(not isinstance(X, tuple), name, 0,
              "(re, im) pair operands need Python-number alpha/beta off "
              "the card")


def _fast_tiles_or_none(A, backend: str, n: Optional[int] = None,
                        op: str = "potrf", scalars=()):
    """The tile backend of a BLAS wrapper (``_tiles_for``), or None for the
    oracle: under backend='ref', for a complex tensor (the embedding was
    not chosen: JAX sends it to its oracle too), and for a CPU operand
    given a scalar that is not a Python number (JAX sends a traced one
    there). On the card such a scalar (a 0-d tensor) is read with float()
    and the kernel runs."""
    check(backend in BACKENDS and backend != "embed", "blocked", 0,
          f"backend {backend!r} takes no real operand here; expected one of "
          f"{BACKENDS} ('embed' requires complex operands: tensors or "
          "(re, im) pairs)")
    if backend == "ref" or A.is_complex() or (
            A.device.type != "cuda" and not all(map(_static_scalar, scalars))):
        return None
    return _tiles_for(A, backend, n, op)


def _flip_trans(transa):
    """N <-> T; T and C coincide for real dtypes."""
    return (Trans.TRANS if norm_trans(transa) == Trans.NO_TRANS
            else Trans.NO_TRANS)


def gemm(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    """C := alpha·op(A)·op(B) + beta·C (reference cuSgemm). Returns a new
    tensor; C is read only when beta != 0. On the card f32 runs
    ``gemm_f32`` and f64 the Ozaki products; complex as in :func:`potrf`
    (one embedded real product at twice each dimension)."""
    if _route_complex(A, backend) and _embed_scalars_ok(A, (alpha, beta)):
        return _embedding().gemm_split(transa, transb, alpha, A, B, beta, C,
                                       backend=_embed_backend(backend))
    _check_no_stray_pairs("gemm", A, B, C)
    transa, transb = norm_trans(transa), norm_trans(transb)
    t = _fast_tiles_or_none(A, backend, scalars=(alpha, beta))
    if t is None:
        return blas_ref.gemm(transa, transb, alpha, A, B, beta, C)
    alpha, beta = float(alpha), float(beta)
    oA, oB = blas_ref.op(A, transa), blas_ref.op(B, transb)
    check(oA.shape[1] == oB.shape[0], "gemm", 5, "inner dims")
    check(C.shape == (oA.shape[0], oB.shape[1]), "gemm", 7, "C shape")
    return t.mm(oA, oB, C if beta != 0.0 else None, alpha=alpha, beta=beta)


def gemm2(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    """Out-of-place GEMM (reference cuSgemm2): :func:`gemm`."""
    return gemm(transa, transb, alpha, A, B, beta, C, backend=backend)


def syrk(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    """C := alpha·op(A)·op(A)ᵀ + beta·C in the uplo triangle, C's other
    strict triangle kept (reference cuSsyrk). Returns a new tensor. On the
    card f32 runs ``syrk_lower_f32`` (upper through the transposed view of
    the result), f64 the Ozaki ``syrk_ln`` on the whole square. There is
    no complex pair syrk: the complex rank-k update is :func:`herk`."""
    check(not isinstance(A, tuple) and not isinstance(C, tuple), "syrk", 4,
          "the complex rank-k update is herk; the reference has no "
          "csyrk/zsyrk (include/blas.h:57-66)")
    uplo, trans = norm_uplo(uplo), norm_trans(trans)
    t = _fast_tiles_or_none(A, backend, C.shape[0], "syrk",
                            scalars=(alpha, beta))
    if t is None:
        return blas_ref.syrk(uplo, trans, alpha, A, beta, C)
    alpha, beta = float(alpha), float(beta)
    X = A if trans == Trans.NO_TRANS else A.T
    n = X.shape[0]
    check(C.shape == (n, n), "syrk", 6, f"C shape {tuple(C.shape)} != "
          f"{(n, n)}")
    W = C.clone()
    if isinstance(t, _OzakiTiles):
        t.syrk_ln(alpha, X, beta, W)
        return _merge_triangle(W, C, uplo)
    # the lower triangle of W, or of Wᵀ (W's upper); the other stays C's
    t.syrk_ln(alpha, X, beta, W if uplo == Uplo.LOWER else W.T)
    return W


def herk(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    """C := alpha·op(A)·op(A)ᴴ + beta·C, alpha and beta real (reference
    cuCherk). Complex as in :func:`potrf` (one embedded real product,
    ``herk_split``); otherwise f32 is :func:`syrk` and the rest the
    oracle, as in the JAX package (``blocked.py:994-1004``)."""
    if _route_complex(A, backend) and _embed_scalars_ok(A, (alpha, beta),
                                                        real=True):
        return _embedding().herk_split(uplo, trans, alpha, A, beta, C,
                                       backend=_embed_backend(backend))
    _check_no_stray_pairs("herk", A, C)
    if A.dtype == torch.float32:
        tr = Trans.NO_TRANS if norm_trans(trans) == Trans.NO_TRANS \
            else Trans.TRANS
        return syrk(uplo, tr, alpha, A, beta, C, backend=backend)
    return blas_ref.herk(uplo, trans, alpha, A, beta, C)


def trmm(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    """B := alpha·op(A)·B (left) or alpha·B·op(A) (right), A triangular,
    only its uplo triangle referenced (reference cuStrmm). Returns a new
    tensor. All 16 side/uplo/trans/diag combinations reduce to one
    lower-left product: on the card f32 is ONE ``trmm_lln_f32`` launch
    (``_trmm_left_f32``), f64 the Ozaki live-block recursion. Complex as
    in :func:`potrf`: embedded real products over live blocks
    (``trmm_split``), never ``trmm_lln_f32``, as in the JAX package."""
    if _route_complex(A, backend) and _embed_scalars_ok(A, (alpha,)):
        return _embedding().trmm_split(side, uplo, transa, diag, alpha, A, B,
                                       backend=_embed_backend(backend))
    _check_no_stray_pairs("trmm", A, B)
    side, uplo = norm_side(side), norm_uplo(uplo)
    transa, diag = norm_trans(transa), norm_diag(diag)
    t = _fast_tiles_or_none(A, backend, op="trmm", scalars=(alpha,))
    if t is None:
        return blas_ref.trmm(side, uplo, transa, diag, alpha, A, B)
    alpha = float(alpha)
    n = lapack_ref._square(A, "trmm")
    check(B.ndim == 2 and B.shape[0 if side == Side.LEFT else 1] == n,
          "trmm", 6, "dim mismatch")
    if isinstance(t, _KernelTiles):
        left = functools.partial(_trmm_left_f32, A, diag)
    else:
        left = functools.partial(_trmm_left_tiles, t,
                                 blas_ref._tri(A, uplo, diag))
    if side == Side.RIGHT:              # B·op(T) = (op(T)ᵀ·Bᵀ)ᵀ
        return left(uplo, _flip_trans(transa), B.T, alpha).T
    return left(uplo, transa, B, alpha)


def trmm2(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    """Out-of-place TRMM (reference cuStrmm2): :func:`trmm`."""
    return trmm(side, uplo, transa, diag, alpha, A, B, backend=backend)


# leaf width of the live-block trmm recursion over the torch and Ozaki
# tiles: large enough to amortize the Ozaki peel per call, small enough
# that the dead half of each leaf (about nb/2n of the work) stays minor
TRMM_TILES_NB = 512


def _trmm_lln_tiles(L, B, t, nb, out=None):
    """L·B, L exactly lower triangular, by the live-block recursion over
    the tile backend t (the dead upper blocks are never multiplied), into
    ``out`` (allocated when None). A backend with a ``trmm_lln`` method
    (Ozaki: one peel for the whole triangle) takes the whole product."""
    if hasattr(t, "trmm_lln"):
        return t.trmm_lln(L, B, nb)
    if out is None:
        out = torch.empty((L.shape[0], B.shape[1]), dtype=B.dtype,
                          device=B.device)
    n = L.shape[0]
    if n <= nb + nb // 2:           # ragged-tail absorption, as trmm_lln
        return t.mm(L, B, out=out)
    n1 = _split(n, nb)
    _trmm_lln_tiles(L[:n1, :n1], B[:n1], t, nb, out[:n1])
    _trmm_lln_tiles(L[n1:, n1:], B[n1:], t, nb, out[n1:])
    C2 = out[n1:]
    t.mm(L[n1:, :n1], B[:n1], C2, alpha=1.0, beta=1.0, out=C2)
    return out


def _left_lower(uplo, transa):
    """Is op(M) lower triangular, M the uplo triangle?"""
    return (uplo == Uplo.LOWER) == (norm_trans(transa) == Trans.NO_TRANS)


def _trmm_left_tiles(t, M, uplo, transa, B, alpha):
    """op(M)·B over the tiles t, M exactly triangular. An upper op(M)
    reduces to a lower one by the double reversal U·B = flipud(rev(U) ·
    flipud(B)), rev(U) = U reversed in both axes, which is lower."""
    E = M if norm_trans(transa) == Trans.NO_TRANS else M.T
    if _left_lower(uplo, transa):
        out = _trmm_lln_tiles(E, B, t, TRMM_TILES_NB)
    else:
        out = _trmm_lln_tiles(E.flip((0, 1)), B.flip(0), t,
                              TRMM_TILES_NB).flip(0)
    return out if alpha == 1.0 else alpha * out


def _trmm_left_f32(A, diag, uplo, transa, B, alpha):
    """op(T)·B, T the uplo triangle of the f32 A (its diagonal read as 1
    under diag U), by ONE trmm_lln_f32 launch on A's own storage: the
    kernel reads only the triangle, and an upper op(T) through the double
    reversal of :func:`_trmm_left_tiles` on reversed views."""
    E = A if transa == Trans.NO_TRANS else A.T
    return _k.trmm_lln_f32(E, B, alpha=alpha,
                           upper=not _left_lower(uplo, transa),
                           unit=diag == Diag.UNIT)


def trsm(side, uplo, transa, diag, alpha, A, B, backend: str = "auto",
         block_size: Optional[int] = None):
    """Blocked triangular solve by the inverse of each leaf (reference
    cuStrsm): B := alpha·op(A)⁻¹·B (left) or alpha·B·op(A)⁻¹ (right).
    A complex operand the embedding takes is solved there (``trsm_split``,
    complex alpha allowed), any other complex tensor by the oracle, as in
    the JAX package. A real CPU operand with an alpha that is not a Python
    number takes the oracle too (JAX sends a traced one there); on the card
    such an alpha (a 0-d tensor) is read with float() and the kernels run.
    Returns a new tensor; A and B are not modified."""
    if _route_complex(A, backend):
        check(_embed_scalars_ok(A, (alpha,)), "trsm", 5,
              "complex trsm through the embedding needs a Python-number "
              "alpha off the card")
        return _embedding().trsm_split(side, uplo, transa, diag, alpha, A, B,
                                       backend=_embed_backend(backend),
                                       block_size=block_size)
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    diag = norm_diag(diag)
    t = _fast_tiles_or_none(A, backend, A.shape[0], "trsm", scalars=(alpha,))
    if t is None:
        return blas_ref.trsm(side, uplo, transa, diag, alpha, A, B)
    alpha = float(alpha)
    # canonicalize: side=R -> transposed left solve; upper -> lower on Aᵀ
    if side == Side.RIGHT:
        return trsm(Side.LEFT, uplo, _flip_trans(transa), diag, alpha, A,
                    B.T, backend=backend, block_size=block_size).T
    if uplo == Uplo.UPPER:
        return trsm(Side.LEFT, Uplo.LOWER, _flip_trans(transa), diag, alpha,
                    A.T, B, backend=backend, block_size=block_size)
    n = lapack_ref._square(A, "trsm")
    check(B.ndim == 2 and B.shape[0] == n, "trsm", 7,
          f"B shape {tuple(B.shape)} does not match A ({n}x{n})")
    check(B.dtype == A.dtype and B.device == A.device, "trsm", 7,
          "A and B must share dtype and device")
    nb = block_size or t.default_nb
    Lp, Bp = _solve_copy(A, B, alpha, nb, diag == Diag.UNIT)
    if transa == Trans.NO_TRANS:
        _trsm_lln_driver(Lp, Bp, t, nb, unit=False)
    else:
        _trsm_llt_driver(Lp, Bp, t, nb, unit=False)
    return Bp[:n]
