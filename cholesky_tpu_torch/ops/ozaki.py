"""f64 products from exact int8 slice products (the Ozaki scheme).

The counterpart of ``cholesky_tpu/ops/ozaki.py``, the d tier's matmul.
Each row of an f64 operand is scaled by a power of two into [-1/2, 1/2]
and peeled into S slices of 7 bits; every slice product is exact in int32;
products whose slice indices sum to g share the weight 2^(-7(g+2)); the
pairs with s + t >= S are dropped, which bounds the error of an element by
about K·2^(-7S)·rowscale·colscale (S = 6: near f64).

On a CUDA tensor the peel and the grouped products are the kernels
``peel_f32pair`` and ``mm_groups_f32pair`` (ops/kernels/ozaki.py); on a
CPU tensor their plain twins. The device decides: there is no knob.

Each peel is the span ``ozaki.split`` and each product ``ozaki.product``
(``utils/profiling.py``): the torch passes around the two kernels, whose
``kernel.*`` spans they hold.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import ozaki as _kz
from cholesky_tpu_torch.utils import profiling
from cholesky_tpu_torch.utils.errors import check

SLICE_BITS = _kz.SLICE_BITS
# int32 overflow guard of the JAX package: K·65²·S <= 2^31 for S <= 8
# (|q| reaches 65). Beyond it the contraction is cut into exact chunks
# whose products are summed in f64.
K_EXACT_MAX = 2 ** 31 // (65 * 65 * 8)       # = 63550
# the chunk width of matmul_presplit: a multiple of 128 (so the k offset of
# every chunk of a peel suits the kernel's 16-byte loads) below the guard
_K_CHUNK = K_EXACT_MAX // 128 * 128


def _pow2_f32(e):
    """2^e in f32 for an integer tensor e (|e| < 1000), exactly what the
    JAX package's f32 ldexp of 1 gives: built from the bits of the f64
    power of two, whose rounding to f32 is exact for a normal or subnormal
    result, 0 below 2^-149 and inf above 2^127."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64).float()


def scaled_pair(A):
    """(rh, rl, scale): the rows of the f64 matrix A (any strided view) as
    the exact f32 pair rh + rl (48 mantissa bits) in [-1/2, 1/2], and the
    row scales (m,) f64 powers of two with A = 2·scale·(rh + rl), bit for
    bit those of the JAX package: the scale from the f32 frexp of the row
    max, applied as a power of two, which is exact in f32."""
    amax = A.abs().amax(dim=1, keepdim=True)
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    _, ex = torch.frexp(amax.float())
    inv = _pow2_f32(-(ex + 1))                   # 1 / (2·scale)
    scale = _pow2_f32(ex).to(A.dtype)
    xh = A.float()                               # correctly rounded high part
    xl = (A - xh.to(A.dtype)).float()            # exact residual
    return xh * inv, xl * inv, 2.0 * scale[:, 0]


@profiling.annotate_function(
    name="ozaki.split",
    attrs=lambda A, slices: {"m": A.shape[0], "k": A.shape[1],
                             "slices": slices})
def split_rows(A, slices: int):
    """Peel the rows of the f64 matrix A (any strided view) into int8
    slices. Returns (slices (S, m, k) int8, row scales (m,) f64 powers of
    two), bit for bit those of the JAX package. Callers with block
    structure (the hoisted recursions of ops/blocked.py) peel once and feed
    sub-blocks of the same peel to :func:`matmul_presplit`: a sub-block of
    a peel is an exact peel of the sub-block, with the row scale of the
    full row."""
    rh, rl, scale = scaled_pair(A)
    return _kz.peel_f32pair(rh, rl, slices=slices), scale


@profiling.annotate_function(
    name="ozaki.product",
    attrs=lambda As, ascale, Bs, bscale: {"m": As.shape[1], "n": Bs.shape[1],
                                          "k": As.shape[2]})
def matmul_presplit(As, ascale, Bs, bscale):
    """C ≈ A·B from peeled operands: As (S, m, k) with row scales (m,) from
    ``split_rows(A)``, Bs (S, n, k) with scales (n,) from
    ``split_rows(B.T)``. The grouped slice products come back as an exact
    f32 pair (hi, lo), whose ~48 bits sit below the 2^(-7S) floor of the
    dropped pairs."""
    S, m, k = As.shape
    S2, n, k2 = Bs.shape
    check(S == S2 and k == k2, "matmul_presplit", 3,
          f"peels do not match: {tuple(As.shape)} and {tuple(Bs.shape)}")
    if k > K_EXACT_MAX:
        # each chunk keeps the int32 sums exact; the f64 partial products
        # are linear in the scales, so scaling inside each chunk is exact
        acc = torch.zeros((m, n), dtype=torch.float64, device=As.device)
        for c in range(0, k, _K_CHUNK):
            acc += matmul_presplit(As[:, :, c:c + _K_CHUNK], ascale,
                                   Bs[:, :, c:c + _K_CHUNK], bscale)
        return acc
    hi, lo = _kz.mm_groups_f32pair(As, Bs)
    acc = hi.double() + lo.double()
    return acc * ascale[:, None] * bscale[None, :]


def matmul_f64(A, B, *, slices: int = 4):
    """C ≈ A·B for f64 operands (any strided views) through exact int8
    slice products; the error of an element is about
    K·2^(-7·slices)·rowscale(A)_i·colscale(B)_j. Beyond K_EXACT_MAX the
    contraction is cut into chunks, each peeled with its own scales."""
    check(A.dtype == B.dtype == torch.float64, "matmul_f64", 1,
          f"float64 operands only, got {A.dtype} and {B.dtype}")
    check(A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0],
          "matmul_f64", 2,
          f"inner dims {tuple(A.shape)} x {tuple(B.shape)}")
    m, k = A.shape
    n = B.shape[1]
    if k > K_EXACT_MAX:
        nchunks = -(-k // K_EXACT_MAX)
        step = -(-k // nchunks)
        acc = torch.zeros((m, n), dtype=A.dtype, device=A.device)
        for c in range(0, k, step):
            acc += matmul_f64(A[:, c:c + step], B[c:c + step], slices=slices)
        return acc
    As, ascale = split_rows(A, slices)
    Bs, bscale = split_rows(B.T, slices)
    return matmul_presplit(As, ascale, Bs, bscale)
