"""Precision-prefixed API: the s/d/c/z wrappers.

The counterpart of ``cholesky_tpu/ops/typed.py``: the reference exposes
every routine in explicitly typed variants (spotrf, dpotrf, cpotrf, zpotrf,
...; reference include/blas.h and include/lapack.h). Each wrapper checks
the dtype of its matrix argument, as the JAX package's do, and calls the
generic routine. A c/z wrapper also takes the (re, im) pair form, whose
planes must be float32 (c) or float64 (z). As there, there is no
csyrk/zsyrk (the complex rank-k update is cherk/zherk), no s/d herk and
no gemm2.
"""

from __future__ import annotations

import sys

from cholesky_tpu_torch.ops import dispatch
from cholesky_tpu_torch.types import PRECISIONS, real_dtype
from cholesky_tpu_torch.utils.errors import check

_BLAS = ["gemm", "syrk", "trmm", "trmm2", "trsm"]
_LAPACK = ["potrf", "potf2", "trtri", "trtri2", "trti2", "lauum", "lauu2",
           "potri", "logdet"]

# each typed routine, and which positional argument carries its matrix
_MATRIX_ARG = {
    "gemm": 3, "syrk": 3, "herk": 3, "trmm": 5, "trmm2": 5, "trsm": 5,
    "potrf": 1, "potf2": 1, "trtri": 2, "trtri2": 2, "trti2": 2, "lauum": 1,
    "lauu2": 1, "potri": 1, "logdet": 1,
}


def _make(letter: str, name: str):
    dtype = PRECISIONS[letter]
    # the planes of a c/z pair operand
    pair_dtype = real_dtype(dtype) if dtype.is_complex else None
    generic = getattr(dispatch, name)
    argpos = _MATRIX_ARG[name]

    def typed(*args, **kwargs):
        A = args[argpos]
        if isinstance(A, tuple):
            check(pair_dtype is not None and A[0].dtype == pair_dtype,
                  letter + name, argpos + 1,
                  f"an (re, im) pair for {letter}{name} must carry "
                  f"{pair_dtype} planes, got {A[0].dtype}")
        else:
            check(A.dtype == dtype, letter + name, argpos + 1,
                  f"expected {dtype}, got {A.dtype}")
        return generic(*args, **kwargs)

    typed.__name__ = typed.__qualname__ = letter + name
    typed.__doc__ = (f"{dtype}-typed {name} (reference {letter}{name}); "
                     f"see the generic ``{name}`` for semantics.")
    return typed


_mod = sys.modules[__name__]
__all__ = []
for _letter in PRECISIONS:
    _names = _BLAS + _LAPACK
    if _letter in ("c", "z"):
        _names = [n for n in _names if n != "syrk"] + ["herk"]
    for _name in _names:
        setattr(_mod, _letter + _name, _make(_letter, _name))
        __all__.append(_letter + _name)
