"""Complex routines through the interleaved real embedding.

The counterpart of ``cholesky_tpu/ops/complex_embed.py``. Each complex
entry a + bi becomes the 2×2 real block [[a, −b], [b, a]]. The map E is a
*-algebra homomorphism, E(X·Y) = E(X)·E(Y), E(Xᴴ) = E(X)ᵀ and
E(X⁻¹) = E(X)⁻¹, and for an HPD A the factor of E(A) is E(chol(A)),
lower triangular because a complex Cholesky factor has a real diagonal.
So the complex drivers and BLAS run on the real tiles at twice the size:
c64 on the f32 CUDA kernels, c128 on the d tier (Ozaki), with operands
given as complex tensors or as (re, im) pairs of real planes (a pair in,
a pair out).

The layout stays interleaved, as in the JAX package: the block layout
[[R, −I], [I, R]] of a lower-triangular factor is not triangular. The
JAX package builds the interleave from 2-D row interleaves only, for the
TPU's (8, 128) tiling; here it is one ``torch.stack`` and a reshape.

Cost: a real 2n potrf is 8n³/3 flops against 4n³/3 for a complex one, a
2× overhead paid for running on the real kernels.

logdet: det(E(A)) = |det(A)|² = det(A)² for an HPD A, so logdet(A) is
½·logdet(E(A)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cholesky_tpu_torch.ops import blocked
from cholesky_tpu_torch.types import (Diag, Side, Trans, Uplo, norm_diag,
                                      norm_side, norm_trans, norm_uplo)


def embed(re, im):
    """(n, m) real and imaginary planes → the (2n, 2m) interleaved real
    embedding, a new contiguous tensor."""
    n, m = re.shape
    top = torch.stack([re, -im], dim=-1)       # rows 2i:   [a, −b]
    bot = torch.stack([im, re], dim=-1)        # rows 2i+1: [b, a]
    return torch.stack([top, bot], dim=1).reshape(2 * n, 2 * m)


def unembed(M) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2n, 2m) interleaved embedding → contiguous (re, im) planes, read
    at the a and b positions (the exact inverse of :func:`embed` on an
    embedded matrix)."""
    n2, m2 = M.shape
    B = M.reshape(n2 // 2, 2, m2 // 2, 2)
    return B[:, 0, :, 0].contiguous(), B[:, 1, :, 0].contiguous()


def _split(A):
    if isinstance(A, tuple):
        return A
    return A.real, A.imag


def _merge_triangle_planes(rr, ri, ar, ai, uplo):
    """The selected triangle from the result planes, the opposite strict
    triangle from the caller's planes (the drivers' storage contract, as
    ``blocked._merge_triangle``)."""
    if norm_uplo(uplo) == Uplo.LOWER:
        return (torch.tril(rr) + torch.triu(ar, 1),
                torch.tril(ri) + torch.triu(ai, 1))
    return (torch.triu(rr) + torch.tril(ar, -1),
            torch.triu(ri) + torch.tril(ai, -1))


def _scale_planes(alpha, rr, ri):
    """(re, im) planes of alpha·(rr + i·ri). alpha is a Python number,
    complex allowed (the reference's c/z routines take a complex alpha),
    or a 0-d tensor, read with complex()."""
    a = complex(alpha)
    if a.imag == 0.0:
        return a.real * rr, a.real * ri
    return a.real * rr - a.imag * ri, a.real * ri + a.imag * rr


def _merge(re, im, like):
    """The result in the caller's form: a pair, or a complex tensor of
    ``like``'s dtype."""
    if isinstance(like, tuple):
        return re, im
    return torch.complex(re, im).to(like.dtype)


def _info(info_e):
    """The complex pivot of an embedded one: 2k−1 or 2k ↦ k."""
    return torch.where(info_e > 0, (info_e + 1) // 2, 0).to(torch.int32)


def _lower_planes(re, im, uplo):
    """The lower form of the uplo triangle: an upper triangle becomes its
    conjugate transpose (reᵀ, −imᵀ)."""
    if uplo == Uplo.UPPER:
        return re.T, -im.T
    return re, im


def potrf_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex Cholesky through the embedding. ``A`` is a complex tensor
    or an (re, im) pair of real planes; the result takes the same form.
    Returns (factor, info), info the 1-based complex pivot. The opposite
    strict triangle of the caller's matrix passes through."""
    uplo = norm_uplo(uplo)
    re0, im0 = _split(A)
    re, im = _lower_planes(re0, im0, uplo)
    F, info_e = blocked.potrf(Uplo.LOWER, embed(re, im), backend=backend,
                              block_size=block_size)
    fr, fi = unembed(torch.tril(F))
    fr, fi = _lower_planes(fr, fi, uplo)       # back: (Lᴴ) = (frᵀ, −fiᵀ)
    fr, fi = _merge_triangle_planes(fr, fi, re0, im0, uplo)
    return _merge(fr, fi, A), _info(info_e)


def _real_diag_form(re, im):
    """Factor a complex lower-triangular L as U·L′, U = diag(d/|d|)
    unitary and L′ = diag(u)·L with a real positive diagonal, so that E(L′)
    is lower triangular (the embedding of a complex diagonal puts −Im d
    above the diagonal, which a real driver's tril would drop). Exact
    elementwise. Returns (re′, im′, ur, ui) with u = conj(d)/|d|."""
    dr, di = torch.diagonal(re), torch.diagonal(im)
    mag = torch.sqrt(dr * dr + di * di)
    zero = mag == 0
    safe = torch.where(zero, torch.ones_like(mag), mag)
    ur = torch.where(zero, torch.ones_like(mag), dr / safe)
    ui = torch.where(zero, torch.zeros_like(mag), -di / safe)
    rep = re * ur[:, None] - im * ui[:, None]
    imp = re * ui[:, None] + im * ur[:, None]
    return rep, imp, ur, ui


def _unit_planes(re, im):
    """The planes of a unit-diagonal triangle: the stored diagonal is not
    referenced, so its imaginary part must not reach the embedding, where
    it would sit below the diagonal. (The JAX package embeds it as it is,
    which is right only for a stored diagonal with no imaginary part.)"""
    im = im.clone()
    im.diagonal().zero_()
    return re, im


def trtri_split(uplo, diag, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex triangular inverse through the embedding, with the
    real-diagonal form making the embedding triangular:
    L⁻¹ = L′⁻¹·diag(u). With diag='U' the stored diagonal passes through,
    as LAPACK's. Returns (inverse, info)."""
    uplo, diag = norm_uplo(uplo), norm_diag(diag)
    re0, im0 = _split(A)
    re, im = _lower_planes(re0, im0, uplo)
    unit = diag == Diag.UNIT
    if unit:
        d_im = torch.diagonal(im).clone()
        re, im = _unit_planes(re, im)
    else:
        re, im, ur, ui = _real_diag_form(re, im)
    W, info_e = blocked.trtri(Uplo.LOWER, diag, embed(re, im),
                              backend=backend, block_size=block_size)
    wr, wi = unembed(torch.tril(W))
    if unit:
        wi.diagonal().copy_(d_im)
    else:
        # scale the columns by u: the diagonal 1/|d| becomes 1/d
        wr, wi = (wr * ur[None, :] - wi * ui[None, :],
                  wr * ui[None, :] + wi * ur[None, :])
    wr, wi = _lower_planes(wr, wi, uplo)
    wr, wi = _merge_triangle_planes(wr, wi, re0, im0, uplo)
    return _merge(wr, wi, A), _info(info_e)


def lauum_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex Lᴴ·L (U·Uᴴ) through the embedding, on the real-diagonal
    form: the unitary row scaling cancels in Lᴴ·L = L′ᴴ·L′."""
    uplo = norm_uplo(uplo)
    re0, im0 = _split(A)
    re, im = _lower_planes(re0, im0, uplo)
    re, im, _, _ = _real_diag_form(re, im)
    R = blocked.lauum(Uplo.LOWER, embed(re, im), backend=backend,
                      block_size=block_size)
    # the result is Hermitian, its embedding symmetric: complete it from
    # the lower triangle before reading the planes
    rr, ri = unembed(torch.tril(R) + torch.tril(R, -1).T)
    rr, ri = _lower_planes(rr, ri, uplo)
    rr, ri = _merge_triangle_planes(rr, ri, re0, im0, uplo)
    return _merge(rr, ri, A)


def potri_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex HPD inverse from the Cholesky factor: trtri then lauum."""
    W, info = trtri_split(uplo, Diag.NON_UNIT, A, backend=backend,
                          block_size=block_size)
    return lauum_split(uplo, W, backend=backend, block_size=block_size), info


def logdet_split(uplo, A, backend: str = "auto",
                 block_size: Optional[int] = None):
    """Complex HPD log|det| through the embedding: ½·logdet(E(A))."""
    uplo = norm_uplo(uplo)
    re, im = _lower_planes(*_split(A), uplo)
    val, info_e = blocked.logdet(Uplo.LOWER, embed(re, im), backend=backend,
                                 block_size=block_size)
    return 0.5 * val, _info(info_e)


def _op_planes(re, im, trans):
    """op (N, T or C) of a complex matrix given as planes."""
    t = norm_trans(trans)
    if t == Trans.NO_TRANS:
        return re, im
    if t == Trans.TRANS:
        return re.T, im.T
    return re.T, -im.T


def gemm_split(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    """Complex GEMM through the embedding, E(α·op(A)·op(B) + β·C) =
    α·E(op A)·E(op B) + β·E(C): one real product at twice each dimension.
    Complex α, β are applied to the planes after a unit-scalar product.
    The result takes C's form."""
    al, be = complex(alpha), complex(beta)
    ar, ai = _op_planes(*_split(A), transa)
    br, bi = _op_planes(*_split(B), transb)
    cr, ci = _split(C)
    if al.imag == 0.0 and be.imag == 0.0:
        out = blocked.gemm("N", "N", al.real, embed(ar, ai), embed(br, bi),
                           be.real, embed(cr, ci), backend=backend)
        return _merge(*unembed(out), C)
    out = blocked.gemm("N", "N", 1.0, embed(ar, ai), embed(br, bi), 0.0,
                       embed(cr, ci), backend=backend)
    sr, si = _scale_planes(al, *unembed(out))
    tr, ti = _scale_planes(be, cr, ci)
    return _merge(sr + tr, si + ti, C)


def herk_split(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    """Complex HERK through the embedding: with X = op(A),
    E(α·X·Xᴴ + β·C) = α·E(X)·E(X)ᵀ + β·E(C), α and β real. Only the
    selected triangle of C is read; the result's diagonal is exactly real
    and the opposite strict triangle of C passes through."""
    uplo = norm_uplo(uplo)
    t = norm_trans(trans)
    xr, xi = _op_planes(*_split(A), "N" if t == Trans.NO_TRANS else "C")
    cr, ci = _split(C)
    # the Hermitian completion of the selected triangle
    if uplo == Uplo.LOWER:
        hr = torch.tril(cr) + torch.tril(cr, -1).T
        hi = torch.tril(ci, -1) - torch.tril(ci, -1).T
    else:
        hr = torch.triu(cr) + torch.triu(cr, 1).T
        hi = torch.triu(ci, 1) - torch.triu(ci, 1).T
    EX = embed(xr, xi)
    out = blocked.gemm("N", "T", alpha, EX, EX, beta, embed(hr, hi),
                       backend=backend)
    rr, ri = unembed(out)
    ri.diagonal().zero_()
    rr, ri = _merge_triangle_planes(rr, ri, cr, ci, uplo)
    return _merge(rr, ri, C)


# leaf width of the live-block complex trmm recursion (the embedded real
# product runs at 2n, so a 512 complex leaf is a 1024 real product)
_TRMM_PLANES_NB = 512


def _trmm_lln_planes(tr, ti, br, bi, backend, nb=_TRMM_PLANES_NB):
    """L·B for an exactly lower-triangular complex L given as planes, by
    the live-block recursion: diagonal blocks recurse, the block below
    them is ONE embedded real product, the dead upper blocks are never
    multiplied. Every product is a real gemm, as in the JAX package (not
    the f32 trmm kernel)."""
    n = tr.shape[0]
    if n <= nb + nb // 2:                   # ragged-tail absorption
        EB = embed(br, bi)
        return unembed(blocked.gemm("N", "N", 1.0, embed(tr, ti), EB, 0.0,
                                    EB, backend=backend))
    n1 = blocked._split(n, nb)
    c1r, c1i = _trmm_lln_planes(tr[:n1, :n1], ti[:n1, :n1], br[:n1],
                                bi[:n1], backend, nb)
    c2r, c2i = _trmm_lln_planes(tr[n1:, n1:], ti[n1:, n1:], br[n1:],
                                bi[n1:], backend, nb)
    out = blocked.gemm("N", "N", 1.0, embed(tr[n1:, :n1], ti[n1:, :n1]),
                       embed(br[:n1], bi[:n1]), 1.0, embed(c2r, c2i),
                       backend=backend)
    c2r, c2i = unembed(out)
    return torch.cat([c1r, c2r]), torch.cat([c1i, c2i])


def trmm_split(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    """Complex TRMM through the embedding: the triangle (and a unit
    diagonal) is masked at the complex level, every side/uplo/trans form
    is canonicalized onto the (left, lower, no-trans) live-block
    recursion, and α (complex allowed) scales the planes."""
    side, uplo = norm_side(side), norm_uplo(uplo)
    diag, transa = norm_diag(diag), norm_trans(transa)
    ar, ai = _split(A)
    tri = torch.tril if uplo == Uplo.LOWER else torch.triu
    tr, ti = tri(ar), tri(ai)               # new tensors
    if diag == Diag.UNIT:
        tr.diagonal().fill_(1.0)
        ti.diagonal().zero_()
    br, bi = _split(B)
    if side == Side.LEFT:
        er, ei = _op_planes(tr, ti, transa)
        transposed = transa != Trans.NO_TRANS
    else:
        # B·op(T) = (op(T)ᵀ·Bᵀ)ᵀ with plain transposes (valid over ℂ):
        # op(T)ᵀ is Tᵀ (N), T (T) or conj(T) (C)
        if transa == Trans.NO_TRANS:
            er, ei, transposed = tr.T, ti.T, True
        elif transa == Trans.TRANS:
            er, ei, transposed = tr, ti, False
        else:
            er, ei, transposed = tr, -ti, False
        br, bi = br.T, bi.T
    if (uplo == Uplo.LOWER) != transposed:
        rr, ri = _trmm_lln_planes(er, ei, br, bi, backend)
    else:
        # an upper op(T): the double reversal U·B = flipud(rev(U)·flipud(B))
        rr, ri = _trmm_lln_planes(er.flip((0, 1)), ei.flip((0, 1)),
                                  br.flip(0), bi.flip(0), backend)
        rr, ri = rr.flip(0), ri.flip(0)
    if side == Side.RIGHT:
        rr, ri = rr.T, ri.T
    return _merge(*_scale_planes(alpha, rr, ri), B)


def _trsm_lower_left(ar, ai, br, bi, trans, unit, backend, block_size):
    """Solve op(L)·X = B for a complex lower-triangular L given as planes,
    through the real-diagonal form L = U·L′ (U = diag(d/|d|)):
      N: X = L′⁻¹·(U⁻¹·B)     pre-scale the rows by u = conj(d)/|d|
      C: X = U·(L′ᴴ)⁻¹·B      post-scale the rows by conj(u)
      T: conj(L)ᴴ·X = B       solve as 'C' of conj(L)"""
    if trans == "T":
        return _trsm_lower_left(ar, -ai, br, bi, "C", unit, backend,
                                block_size)
    if unit:
        ar, ai = _unit_planes(ar, ai)
    else:
        ar, ai, ur, ui = _real_diag_form(ar, ai)
        if trans == "N":
            br, bi = (br * ur[:, None] - bi * ui[:, None],
                      br * ui[:, None] + bi * ur[:, None])
    X = blocked.trsm("L", "L", "N" if trans == "N" else "T",
                     "U" if unit else "N", 1.0, embed(ar, ai), embed(br, bi),
                     backend=backend, block_size=block_size)
    xr, xi = unembed(X)
    if trans == "C" and not unit:
        xr, xi = (xr * ur[:, None] + xi * ui[:, None],
                  xi * ur[:, None] - xr * ui[:, None])
    return xr, xi


def trsm_split(side, uplo, transa, diag, alpha, A, B, backend: str = "auto",
               block_size: Optional[int] = None):
    """Complex triangular solve through the embedding. ``A`` and ``B`` are
    complex tensors or (re, im) pairs; α (complex allowed) pre-scales the
    right-hand side, X being linear in B. Every side/uplo/trans form is
    canonicalized at the complex level before embedding: the embedding of
    an upper-triangular complex matrix is not upper triangular."""
    side, uplo = norm_side(side), norm_uplo(uplo)
    transa, diag = norm_trans(transa), norm_diag(diag)
    unit = diag == Diag.UNIT
    ar, ai = _split(A)
    br, bi = _scale_planes(alpha, *_split(B))
    t = {Trans.NO_TRANS: "N", Trans.TRANS: "T", Trans.CONJ_TRANS: "C"}[transa]

    # side R: X·op(A) = B ⟺ op(A)ᵀ·Xᵀ = Bᵀ, a left solve on transposes
    if side == Side.RIGHT:
        if t == "C":
            # op(A)ᵀ = conj(A): A·conj(Xᵀ) = conj(Bᵀ)
            xr, xi = _split(trsm_split(Side.LEFT, uplo, "N", diag, 1.0,
                                       (ar, ai), (br.T, -bi.T),
                                       backend=backend,
                                       block_size=block_size))
            return _merge(xr.T, -xi.T, B)
        xr, xi = _split(trsm_split(Side.LEFT, uplo, "T" if t == "N" else "N",
                                   diag, 1.0, (ar, ai), (br.T, bi.T),
                                   backend=backend, block_size=block_size))
        return _merge(xr.T, xi.T, B)

    # uplo U: lower on A′ = Aᴴ, so that U = A′ᴴ
    if uplo == Uplo.UPPER:
        ar, ai = ar.T, -ai.T
        if t == "T":
            # Uᵀ·X = conj(A′)·X = B ⟺ A′·conj(X) = conj(B)
            xr, xi = _trsm_lower_left(ar, ai, br, -bi, "N", unit, backend,
                                      block_size)
            return _merge(xr, -xi, B)
        t = "C" if t == "N" else "N"
    return _merge(*_trsm_lower_left(ar, ai, br, bi, t, unit, backend,
                                    block_size), B)
