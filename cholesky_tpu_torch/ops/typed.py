"""Precision-prefixed API: the s/d wrappers of the routines ported so far.

The counterpart of ``cholesky_tpu/ops/typed.py``: the reference exposes
every routine in explicitly typed variants (spotrf, dpotrf, ...; reference
include/blas.h and include/lapack.h). Each wrapper checks the dtype of its
matrix argument, as the JAX package's do, and calls the generic routine.
As there, herk has no s/d wrapper and gemm2 none at all; the c/z letters
come with their slice.
"""

from __future__ import annotations

import sys

from cholesky_tpu_torch.ops import dispatch
from cholesky_tpu_torch.types import PRECISIONS
from cholesky_tpu_torch.utils.errors import check

LETTERS = ("s", "d")

# each typed routine, and which positional argument carries its matrix
_MATRIX_ARG = {
    "gemm": 3, "syrk": 3, "trmm": 5, "trmm2": 5, "trsm": 5,
    "potrf": 1, "potf2": 1, "trtri": 2, "trtri2": 2, "trti2": 2, "lauum": 1,
    "lauu2": 1, "potri": 1, "logdet": 1,
}


def _make(letter: str, name: str):
    dtype = PRECISIONS[letter]
    generic = getattr(dispatch, name)
    argpos = _MATRIX_ARG[name]

    def typed(*args, **kwargs):
        A = args[argpos]
        check(A.dtype == dtype, letter + name, argpos + 1,
              f"expected {dtype}, got {A.dtype}")
        return generic(*args, **kwargs)

    typed.__name__ = typed.__qualname__ = letter + name
    typed.__doc__ = (f"{dtype}-typed {name} (reference {letter}{name}); "
                     f"see the generic ``{name}`` for semantics.")
    return typed


_mod = sys.modules[__name__]
__all__ = []
for _letter in LETTERS:
    for _name in _MATRIX_ARG:
        setattr(_mod, _letter + _name, _make(_letter, _name))
        __all__.append(_letter + _name)
