"""cholesky_tpu_torch: the PyTorch and CUDA port of cholesky_tpu.

The ported slice is f32 (and, through the torch tile, f64) ``potrf`` and
``logdet``, lower and upper, with LAPACK ``info`` semantics. On an NVIDIA
Hopper card a float32 tensor runs through four hand-written CUDA kernels
(ops/kernels/); a CPU tensor runs through plain torch. ``cholesky_tpu``
stays the reference the port is tested against.
"""

from cholesky_tpu_torch.ops.api import logdet, logdet_from_factor, potrf
from cholesky_tpu_torch.types import Diag, Side, Trans, Uplo
from cholesky_tpu_torch.utils.errors import set_error_handler, set_xerbla

__all__ = [
    "potrf", "logdet", "logdet_from_factor",
    "Side", "Uplo", "Trans", "Diag",
    "set_error_handler", "set_xerbla",
]
