"""Plain inverse of an SPD matrix from its Cholesky factor: the reference
of ``potri("L", L)``. L⁻¹ by one triangular solve against the identity,
then the lower triangle of L⁻ᵀ·L⁻¹ (LAPACK's xPOTRI is xTRTRI then
xLAUUM, the same two products in blocks).

``prec`` is ``"f64"`` (the reference) or ``"f32"`` (the control: float32
storage, solve and product, with TF32 off as ``reference/__init__.py``
sets it on import: the step below the float64 that the d tier's
configuration states).
"""

import torch

DTYPES = {"f64": torch.float64, "f32": torch.float32}


def potri_lower(L, prec="f64"):
    """tril((L·Lᵀ)⁻¹) for the lower-triangular factor L (only its lower
    triangle is read), in ``prec``."""
    T = torch.tril(L.to(DTYPES[prec]))
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    inv = torch.linalg.solve_triangular(T, eye, upper=False)
    del eye
    return torch.tril(torch.matmul(inv.T, inv))
