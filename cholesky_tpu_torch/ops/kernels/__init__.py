"""The hand-written CUDA kernels of the f32 potrf, trsm, trtri, lauum,
potri, potf2 and trmm paths, of the d tier's Ozaki products, of the
device fills and of the GP model's RBF kernel, each beside its plain torch
twin. The complex tier runs on
the same kernels through the real embedding. Nothing is compiled at
import: the first launch builds ``csrc/`` (see ``_build.py``)."""

from cholesky_tpu_torch.ops.kernels.gemm import gemm_f32
from cholesky_tpu_torch.ops.kernels.leaf import lauu2_f32, potf2_f32, trti2_f32
from cholesky_tpu_torch.ops.kernels.mega import (lauum_stream_f32,
                                                 potrf_block_f32,
                                                 potrf_stream_f32,
                                                 trtri_block_f32,
                                                 trtri_stream_f32)
from cholesky_tpu_torch.ops.kernels.ozaki import (mm_groups_f32pair,
                                                  mm_groups_f64, peel_f32pair,
                                                  peel_f64)
from cholesky_tpu_torch.ops.kernels.prng import (uniform_fill_f32,
                                                 uniform_fill_f64)
from cholesky_tpu_torch.ops.kernels.rbf import rbf_f32, rbf_grad_f32
from cholesky_tpu_torch.ops.kernels.syrk import syrk_lower_f32
from cholesky_tpu_torch.ops.kernels.trmm import trmm_lln_f32

#: kernel name -> its wrapper, which counts its launches in ``.launches``
KERNELS = {
    "gemm_f32": gemm_f32,
    "syrk_lower_f32": syrk_lower_f32,
    "potrf_block_f32": potrf_block_f32,
    "potrf_stream_f32": potrf_stream_f32,
    "trtri_block_f32": trtri_block_f32,
    "trtri_stream_f32": trtri_stream_f32,
    "lauum_stream_f32": lauum_stream_f32,
    "lauu2_f32": lauu2_f32,
    "potf2_f32": potf2_f32,
    "trti2_f32": trti2_f32,
    "trmm_lln_f32": trmm_lln_f32,
    "peel_f32pair": peel_f32pair,
    "mm_groups_f32pair": mm_groups_f32pair,
    "peel_f64": peel_f64,
    "mm_groups_f64": mm_groups_f64,
    "uniform_fill_f32": uniform_fill_f32,
    "uniform_fill_f64": uniform_fill_f64,
    "rbf_f32": rbf_f32,
    "rbf_grad_f32": rbf_grad_f32,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
