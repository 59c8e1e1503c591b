"""The hand-written CUDA kernels of the f32 potrf path, each beside its
plain torch twin. Nothing is compiled at import: the first launch builds
``csrc/`` (see ``_build.py``)."""

from cholesky_tpu_torch.ops.kernels.gemm import gemm_f32
from cholesky_tpu_torch.ops.kernels.mega import (potrf_block_f32,
                                                 trtri_block_f32)
from cholesky_tpu_torch.ops.kernels.syrk import syrk_lower_f32

#: kernel name -> its wrapper, which counts its launches in ``.launches``
KERNELS = {
    "gemm_f32": gemm_f32,
    "syrk_lower_f32": syrk_lower_f32,
    "potrf_block_f32": potrf_block_f32,
    "trtri_block_f32": trtri_block_f32,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
