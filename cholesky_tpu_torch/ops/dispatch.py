"""Backend dispatch for the ported routines.

The counterpart of ``cholesky_tpu/ops/dispatch.py`` for gemm, syrk, herk,
trmm, trmm2, trsm, potrf, potf2, logdet, logdet_from_factor, trtri, trtri2,
trti2, lauum, lauu2 and potri (``gemm2`` stays in ops/blocked.py and
ops/blas_ref.py, as in the JAX package).
Backends: 'ref' (the oracle tier, ops/lapack_ref.py and ops/blas_ref.py),
'torch' (the blocked recursions over torch matmuls, the JAX package's
'xla'), 'cuda' (the blocked recursions over the hand-written f32 CUDA
kernels, its 'pallas'), 'ozaki' (the f64 d tier: exact int8 slice products
through two more kernels, as the JAX package's 'ozaki'), 'embed' (complex
operands through the interleaved real embedding, ops/complex_embed.py)
and 'auto' ('cuda' for a float32 CUDA tensor, 'ozaki' for a float64 CUDA
tensor, 'embed' for a complex CUDA tensor, 'torch' on the CPU; an
(re, im) pair always takes the embedding).

Each routine is the span ``api.<routine>`` (``utils/profiling.py``),
whose attributes are its first matrix operand's shape and dtype and the
backend that ``auto`` resolves to.
"""

from __future__ import annotations

import functools

import torch

from cholesky_tpu_torch.ops import blocked, lapack_ref
from cholesky_tpu_torch.utils import profiling


def _resolved(A, backend: str) -> str:
    if backend != "auto":
        return backend
    plane = A[0] if isinstance(A, tuple) else A
    if plane.device.type != "cuda":
        return "torch"
    if isinstance(A, tuple) or A.is_complex():
        return "embed"
    return "ozaki" if A.dtype == torch.float64 else "cuda"


def _attrs(*args, backend: str | None = None, **kwargs) -> dict:
    """A span's attributes: those of the first operand that is a tensor
    or an (re, im) pair, and the backend ``auto`` resolves to for it."""
    for A in (*args, *kwargs.values()):
        if isinstance(A, (torch.Tensor, tuple)):
            plane = A[0] if isinstance(A, tuple) else A
            return {"shape": tuple(plane.shape),
                    "dtype": str(plane.dtype).removeprefix("torch."),
                    "pair": isinstance(A, tuple),
                    "backend": _resolved(A, backend or "auto")}
    return {}


def _span(name, fn):
    return profiling.annotate_function(fn, f"api.{name}", attrs=_attrs)


def _wrap(name):
    impl = getattr(blocked, name)

    @functools.wraps(impl)
    def fn(*args, backend: str | None = None, **kwargs):
        return impl(*args, backend=backend or "auto", **kwargs)

    return _span(name, fn)


gemm = _wrap("gemm")
syrk = _wrap("syrk")
herk = _wrap("herk")
trmm = _wrap("trmm")
trmm2 = _wrap("trmm2")
trsm = _wrap("trsm")

potrf = _wrap("potrf")
potf2 = _wrap("potf2")
trtri = _wrap("trtri")
trtri2 = _wrap("trtri2")
trti2 = _wrap("trti2")
lauum = _wrap("lauum")
lauu2 = _wrap("lauu2")
potri = _wrap("potri")
logdet = _wrap("logdet")
logdet_from_factor = _span("logdet_from_factor",
                           lapack_ref.logdet_from_factor)
