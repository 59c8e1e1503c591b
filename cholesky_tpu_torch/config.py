"""Library-wide configuration: the f32 matmul policy.

The counterpart of ``cholesky_tpu/config.py``, whose ``Precision.HIGHEST``
keeps XLA's f32 matmuls full-precision on the TPU. On an NVIDIA card the
same trap is TF32: it keeps about three decimal digits and would break
every eps-scaled bound in the library and its tests. Importing this module
turns TF32 off for both cuBLAS matmuls and cuDNN and asks for "highest"
f32 matmul precision. The hand-written kernels multiply in plain f32 FFMA
and do not depend on these flags; the torch tile backend, the plain twins
and the oracles do.

There is no interpret mode: the device is taken from each tensor.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
