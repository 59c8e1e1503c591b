"""Public API of the ported routines; backends in ops/dispatch.py
('ref', 'torch', 'cuda', 'ozaki', 'embed', 'auto'), the s/d/c/z typed
variants in ops/typed.py."""

from __future__ import annotations

from cholesky_tpu_torch.ops import dispatch as _dispatch

# BLAS L3
gemm = _dispatch.gemm
syrk = _dispatch.syrk
herk = _dispatch.herk
trmm = _dispatch.trmm
trmm2 = _dispatch.trmm2
trsm = _dispatch.trsm

# LAPACK
potrf = _dispatch.potrf
potf2 = _dispatch.potf2
trtri = _dispatch.trtri
trtri2 = _dispatch.trtri2
trti2 = _dispatch.trti2
lauum = _dispatch.lauum
lauu2 = _dispatch.lauu2
potri = _dispatch.potri
logdet = _dispatch.logdet
logdet_from_factor = _dispatch.logdet_from_factor
