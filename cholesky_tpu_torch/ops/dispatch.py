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
"""

from __future__ import annotations

import functools

from cholesky_tpu_torch.ops import blocked, lapack_ref


def _wrap(name):
    impl = getattr(blocked, name)

    @functools.wraps(impl)
    def fn(*args, backend: str | None = None, **kwargs):
        return impl(*args, backend=backend or "auto", **kwargs)

    return fn


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
logdet_from_factor = lapack_ref.logdet_from_factor
