"""Backend dispatch for the ported routines.

The counterpart of ``cholesky_tpu/ops/dispatch.py`` for potrf, logdet and
logdet_from_factor. Backends: 'ref' (the oracle tier, ops/lapack_ref.py),
'torch' (the blocked recursion over torch matmuls, the JAX package's 'xla'),
'cuda' (the blocked recursion over the hand-written CUDA kernels, its 'pallas')
and 'auto' ('cuda' for a float32 CUDA tensor, 'torch' on the CPU).
"""

from __future__ import annotations

import functools

from cholesky_tpu_torch.ops import blocked, lapack_ref


def _wrap_lapack(name):
    impl = getattr(blocked, name)

    @functools.wraps(impl)
    def fn(*args, backend: str | None = None, **kwargs):
        return impl(*args, backend=backend or "auto", **kwargs)

    return fn


potrf = _wrap_lapack("potrf")
logdet = _wrap_lapack("logdet")
logdet_from_factor = lapack_ref.logdet_from_factor
