"""Condition-numbered SPD test matrices (reference
test/lapack/util/slatmc.c:11-70).

The counterpart of ``cholesky_tpu/rng/generators.py``'s ``latmc`` for the
real dtypes. JAX's threefry keys become an explicit ``torch.Generator``,
and the matrix is built on the generator's device, so the smoke run makes
its inputs on the card. The streams differ from JAX's: tests that compare
the two packages hand both the same numpy array instead.
"""

from __future__ import annotations

import torch


def _householder_apply(V, A, side_left: bool):
    """Apply the product of the reflections H(v) = I − 2·v·vᵀ, for the unit
    columns v of V, to A (left: H·A, right: A·H) without forming H."""
    for i in range(V.shape[1]):
        v = V[:, i:i + 1]
        if side_left:
            A = A - 2.0 * (v @ (v.T @ A))
        else:
            A = A - 2.0 * ((A @ v) @ v.T)
    return A


def latmc(generator: torch.Generator, n: int, cond: float = 2.0,
          dtype=torch.float32, rank_correction: int = 2):
    """Random SPD n×n matrix (f32 or f64) with exact 2-norm condition
    number ``cond``: eigenvalues spread linearly over [1, cond], made dense
    by a similarity with ``rank_correction`` random Householder
    reflections. Deterministic under the generator's state; the matrix
    lives on the generator's device."""
    device = generator.device
    lam = torch.linspace(1.0, cond, n, dtype=dtype, device=device)
    V = torch.randn((n, rank_correction), generator=generator, dtype=dtype,
                    device=device)
    V = V / torch.linalg.vector_norm(V, dim=0, keepdim=True)
    # A = Q·diag(lam)·Qᵀ with Q = H(v₁)···H(v_r): exactly symmetric PD
    A = torch.diag(lam)
    A = _householder_apply(V, A, side_left=False)
    A = _householder_apply(V, A, side_left=True)
    # symmetrize against rounding so potrf sees an exactly symmetric input
    return 0.5 * (A + A.T)
