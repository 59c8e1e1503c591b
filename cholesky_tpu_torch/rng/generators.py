"""Uniform generators and condition-numbered SPD/HPD test matrices
(reference include/rng.h:21-101 and test/lapack/util/slatmc.c:11-70).

The counterpart of ``cholesky_tpu/rng/generators.py``. JAX's threefry keys
become an explicit ``torch.Generator``, and everything is built on the
generator's device, so the smoke run makes its inputs on the card. The
streams differ from JAX's: tests that compare the two packages hand both
the same numpy array instead. The contracts are JAX's: seeded
determinism, the four interval variants, and SPD/HPD matrices with an
exact 2-norm condition number.
"""

from __future__ import annotations

import enum

import torch

from cholesky_tpu_torch.types import (Diag, Uplo, norm_diag, norm_uplo,
                                      real_dtype)


class Interval(str, enum.Enum):
    """The four uniform-interval variants of the reference's rng.h
    (Get / GetOpen / GetHalfOpen01 / GetHalfOpen10, rng.h:21-101)."""
    CLOSED = "[0,1]"
    OPEN = "(0,1)"
    HALF_OPEN_01 = "[0,1)"
    HALF_OPEN_10 = "(0,1]"


def interval_transform(u, interval=Interval.HALF_OPEN_01):
    """Map uniform floats u in [0, 1) onto ``interval`` with the JAX
    package's transforms, in u's own dtype (eps its machine epsilon):
    (0, 1] is 1 − u, [0, 1] is u / (1 − eps), (0, 1) is
    u·(1 − eps) + eps."""
    interval = Interval(interval)
    if interval == Interval.HALF_OPEN_01:
        return u
    eps = torch.finfo(u.dtype).eps
    if interval == Interval.HALF_OPEN_10:
        return 1.0 - u
    if interval == Interval.CLOSED:
        return u / (1.0 - eps)
    return u * (1.0 - eps) + eps


def uniform(generator: torch.Generator, shape, dtype=torch.float32,
            interval=Interval.HALF_OPEN_01):
    """Uniform floats of ``shape`` on the generator's device with the
    requested interval semantics."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return interval_transform(u, interval)


def _householder_apply(V, A, side_left: bool):
    """Apply the product of the reflections H(v) = I − 2·v·vᴴ, for the
    unit columns v of V, to A (left: H·A, right: A·H) without forming H."""
    for i in range(V.shape[1]):
        v = V[:, i:i + 1]
        if side_left:
            A = A - 2.0 * (v @ (v.mH @ A))
        else:
            A = A - 2.0 * ((A @ v) @ v.mH)
    return A


def latmc(generator: torch.Generator, n: int, cond: float = 2.0,
          dtype=torch.float32, rank_correction: int = 2):
    """Random SPD (HPD for a complex dtype) n×n matrix with exact 2-norm
    condition number ``cond``: eigenvalues spread linearly over [1, cond],
    made dense by a similarity with ``rank_correction`` random Householder
    reflections. Exactly Hermitian, with a real diagonal. Deterministic
    under the generator's state; the matrix lives on the generator's
    device."""
    device = generator.device
    rdt = real_dtype(dtype)
    lam = torch.linspace(1.0, cond, n, dtype=rdt, device=device)
    V = torch.randn((n, rank_correction), generator=generator, dtype=rdt,
                    device=device)
    if dtype.is_complex:
        # torch.complex keeps the target width
        V = torch.complex(V, torch.randn((n, rank_correction),
                                         generator=generator, dtype=rdt,
                                         device=device))
    V = V / torch.linalg.vector_norm(V, dim=0, keepdim=True)
    # A = Q·diag(lam)·Qᴴ with Q = H(v₁)···H(v_r): exactly Hermitian PD
    A = torch.diag(lam).to(dtype)
    A = _householder_apply(V, A, side_left=False)
    A = _householder_apply(V, A, side_left=True)
    # symmetrize against rounding so potrf sees an exactly Hermitian input
    A = 0.5 * (A + A.mH)
    if dtype.is_complex:
        A.diagonal().imag.zero_()
    return A


def latmc_pair(generator: torch.Generator, n: int, cond: float = 2.0,
               rdtype=torch.float32, rank_correction: int = 2):
    """:func:`latmc` for a complex matrix carried as an (re, im) pair of
    real planes of ``rdtype``: no complex tensor is formed. The pair form
    is the embedding tier's entry (ops/complex_embed.py). The same
    construction and exact-condition contract: re symmetric, im skew with
    a zero diagonal."""
    device = generator.device
    lam = torch.linspace(1.0, cond, n, dtype=rdtype, device=device)
    vr = torch.randn((n, rank_correction), generator=generator, dtype=rdtype,
                     device=device)
    vi = torch.randn((n, rank_correction), generator=generator, dtype=rdtype,
                     device=device)
    nrm = torch.sqrt(torch.sum(vr * vr + vi * vi, dim=0, keepdim=True))
    vr, vi = vr / nrm, vi / nrm

    def pmm(ar, ai, br, bi):
        """(ar + i·ai)(br + i·bi) as four real products."""
        return ar @ br - ai @ bi, ar @ bi + ai @ br

    def happly(ar, ai, left):
        for i in range(rank_correction):
            cr, ci = vr[:, i:i + 1], vi[:, i:i + 1]
            if left:            # A − 2·v·(vᴴ·A)
                wr, wi = pmm(cr.T, -ci.T, ar, ai)
                ur, ui = pmm(cr, ci, wr, wi)
            else:               # A − 2·(A·v)·vᴴ
                wr, wi = pmm(ar, ai, cr, ci)
                ur, ui = pmm(wr, wi, cr.T, -ci.T)
            ar, ai = ar - 2.0 * ur, ai - 2.0 * ui
        return ar, ai

    Ar = torch.diag(lam)
    Ai = torch.zeros((n, n), dtype=rdtype, device=device)
    Ar, Ai = happly(Ar, Ai, left=False)
    Ar, Ai = happly(Ar, Ai, left=True)
    # exactly Hermitian: re symmetric, im skew with a zero diagonal
    Ar = 0.5 * (Ar + Ar.T)
    Ai = 0.5 * (Ai - Ai.T)
    Ai.diagonal().zero_()
    return Ar, Ai


def random_triangular(generator: torch.Generator, n: int, uplo="L",
                      diag="N", dtype=torch.float32,
                      well_conditioned: bool = True):
    """Random triangular matrix for trtri/trsm/trmm tests, entries uniform
    in [−½, ½) (real and imaginary parts). With ``well_conditioned`` each
    diagonal entry d is pushed away from zero to d·(|d| + 1)/|d|; a unit
    diagonal is 1."""
    uplo, diag = norm_uplo(uplo), norm_diag(diag)
    rdt = real_dtype(dtype)
    device = generator.device

    def plane():
        return torch.rand((n, n), generator=generator, dtype=rdt,
                          device=device) - 0.5

    A = torch.complex(plane(), plane()) if dtype.is_complex else plane()
    if well_conditioned:
        d = torch.diagonal(A)
        mag = d.abs()
        zero = mag == 0
        newd = torch.where(zero, (mag + 1.0).to(dtype),
                           d * ((mag + 1.0) / torch.where(zero, 1.0, mag)))
        d.copy_(newd)
    A = torch.tril(A) if uplo == Uplo.LOWER else torch.triu(A)
    if diag == Diag.UNIT:
        A.diagonal().fill_(1.0)
    return A
