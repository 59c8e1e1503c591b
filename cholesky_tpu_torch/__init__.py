"""cholesky_tpu_torch: the PyTorch and CUDA port of cholesky_tpu.

The ported routines are ``potrf``/``potf2``, ``logdet``,
``trtri``/``trtri2``/``trti2``, ``lauum``/``lauu2``, ``potri`` and the
Level-3 BLAS ``gemm``, ``syrk``, ``herk``, ``trmm``/``trmm2`` and ``trsm``
in all four precisions, with LAPACK ``info`` semantics, their typed
s/d/c/z variants (``spotrf``, ``zpotrf``, ``cherk``, ...), the Gaussian-
process model built on them (``cholesky_tpu_torch.models``) and the
generators and device fills of ``cholesky_tpu_torch.rng``. On an NVIDIA
Hopper card a float32 tensor runs through hand-written CUDA kernels, a
float64 tensor through the d tier (exact int8 slice products, two more
kernels, and the f32 leaf kernels), and a complex tensor or an (re, im)
pair through the real embedding onto those two (ops/complex_embed.py); a
CPU tensor runs through plain torch, complex natively. ``cholesky_tpu``
stays the reference the port is tested against.
"""

from cholesky_tpu_torch.ops.api import (gemm, herk, lauu2, lauum, logdet,
                                        logdet_from_factor, potf2, potrf,
                                        potri, syrk, trmm, trmm2, trsm,
                                        trti2, trtri, trtri2)
from cholesky_tpu_torch.ops.typed import *  # noqa: F401,F403
from cholesky_tpu_torch.ops.typed import __all__ as _typed_all
from cholesky_tpu_torch.types import Diag, Side, Trans, Uplo
from cholesky_tpu_torch.utils.errors import (set_error_handler, set_xerbla,
                                             xerbla)

__all__ = [
    "potrf", "potf2", "logdet", "logdet_from_factor",
    "trtri", "trtri2", "trti2", "lauum", "lauu2", "potri",
    "gemm", "syrk", "herk", "trmm", "trmm2", "trsm",
    "Side", "Uplo", "Trans", "Diag",
    "set_error_handler", "set_xerbla", "xerbla",
    *_typed_all,
]
