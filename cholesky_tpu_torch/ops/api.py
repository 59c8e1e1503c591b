"""Public API of the ported routines; backends in ops/dispatch.py."""

from __future__ import annotations

from cholesky_tpu_torch.ops import dispatch as _dispatch

potrf = _dispatch.potrf
logdet = _dispatch.logdet
logdet_from_factor = _dispatch.logdet_from_factor
