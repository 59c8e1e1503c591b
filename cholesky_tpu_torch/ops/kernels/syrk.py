"""syrk_lower_f32: C := alpha·A·Aᵀ + beta·C, lower triangle, in place
(csrc/syrk.cu).

Replaces ``cholesky_tpu/ops/pallas/syrk.py:syrk_f32``. The strict upper
triangle of C is never written. A and C may be strided views of one
working buffer, but must not overlap. A CPU tensor takes the plain twin
:func:`syrk_lower_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.ops.kernels.gemm import _k_fast, _on_grid
from cholesky_tpu_torch.utils.errors import check


def syrk_lower_plain(alpha, A, beta, C):
    """The plain torch version, any dtype and device: updates the lower
    triangle of C in place and returns C. A·Aᴴ for a complex A (the torch
    tile's Hermitian update); Aᴴ is Aᵀ for the kernel's real operands."""
    full = alpha * (A @ A.mH)
    if beta != 0.0:
        full = full + beta * C
    n = C.shape[0]
    lower = torch.ones((n, n), dtype=torch.bool, device=C.device).tril_()
    C.copy_(torch.where(lower, full, C))
    return C


#: the tile edge (csrc/syrk.cu on sgemm128.cuh's tile)
TILE = 128
#: blocks in one wave of the card: two on each of the H100's 132 SMs
#: (__launch_bounds__(256, 2) in csrc/syrk.cu)
WAVE = 264
#: from this many lower tiles a block takes whole tiles, the last wave's
#: tail a small part of the launch; below it the k-steps are cut for one
#: wave (chip_smoke.py's A/B: at 512, 1024 and 2048 runs for 264 blocks
#: ahead of a uniform split of each tile's depth in 1, 2 or 4)
WHOLE_MIN_TILES = 4 * WAVE


def tile_steps(k):
    """k-steps of 16 in a tile's depth (one at k = 0, which still scales
    C by beta)."""
    return max(1, -(-k // 16))


def launch_plan(n, k, strides, ptr, *, split=None, blocks=None):
    """The launch of syrk_lower_f32 for an (n x k) f32 operand A with these
    strides (in elements) and base address: (q, blocks, A k-fast, 16-byte
    staging). The lower TILE x TILE tiles' k-steps of 16, in tile order,
    are cut in runs of q, one a block: whole tiles from WHOLE_MIN_TILES
    tiles, else runs for one WAVE of blocks; a run that ends inside a
    tile leaves a part of it for one more pass to sum. A uniform ``split``
    of each tile's depth or a number of ``blocks`` overrides the rule (the
    A/B of chip_smoke.py)."""
    kf = _k_fast(strides[0], strides[1])
    vec = _on_grid(ptr, strides[0], strides[1], kf)
    nt = -(-n // TILE)
    tiles, T = nt * (nt + 1) // 2, tile_steps(k)
    if split is not None:
        q = -(-T // split)
    elif blocks is None and tiles >= WHOLE_MIN_TILES:
        q = T
    else:
        q = -(-tiles * T // (blocks or WAVE))
    return q, -(-tiles * T // q), kf, vec


def _syrk_shape(alpha, A, beta, C):
    return {"n": A.shape[0], "k": A.shape[1], "dtype": _build.dtype_name(A),
            "c_read": beta != 0.0}


@_build.kernel_span("syrk_lower_f32", _syrk_shape)
def syrk_lower_f32(alpha, A, beta, C):
    """Lower triangle of C := alpha·A·Aᵀ + beta·C in place, A (n, k) and
    C (n, n) f32; C is read only when beta != 0. Returns C. A launch whose
    plan splits tiles takes two tiles of scratch a block on the card (at
    most 2·WAVE·128² floats below WHOLE_MIN_TILES tiles), freed on
    return."""
    check(A.ndim == 2 and C.ndim == 2, "syrk_lower_f32", 2,
          "A and C must be 2-D")
    n, k = A.shape
    check(C.shape == (n, n), "syrk_lower_f32", 4,
          f"C shape {tuple(C.shape)} != {(n, n)}")
    check(A.dtype == C.dtype == torch.float32, "syrk_lower_f32", 2,
          "float32 operands only")
    check(A.device == C.device, "syrk_lower_f32", 2,
          "operands on different devices")
    check(_build.writable_2d(C), "syrk_lower_f32", 4,
          "C must be a row- or column-major view without overlap")
    if A.device.type == "cpu":
        return syrk_lower_plain(alpha, A, beta, C)
    check(A.device.type == "cuda", "syrk_lower_f32", 2,
          f"unsupported device {A.device}")
    if n == 0:
        return C
    q, blocks, kf, vec = launch_plan(n, k, A.stride(), A.data_ptr())
    # two partial tiles a block, where runs split tiles
    P = (torch.empty((2 * blocks * TILE * TILE,), dtype=C.dtype,
                     device=C.device) if q % tile_steps(k) else None)
    _build.launch(
        "syrk_lower_f32", A.data_ptr(), A.stride(0), A.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        n, k, float(alpha), float(beta), q, blocks, int(kf), int(vec),
        P.data_ptr() if P is not None else None, *_build.device_args(C))
    syrk_lower_f32.launches += 1
    return C


syrk_lower_f32.launches = 0
