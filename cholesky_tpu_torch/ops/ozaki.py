"""f64 products from exact int8 slice products (the Ozaki scheme).

The counterpart of ``cholesky_tpu/ops/ozaki.py``, the d tier's matmul.
Each row of an f64 operand is scaled by a power of two into [-1/2, 1/2]
and peeled into S slices of 7 bits; every slice product is exact in int32;
products whose slice indices sum to g share the weight 2^(-7(g+2)); the
pairs with s + t >= S are dropped, which bounds the error of an element by
about K·2^(-7S)·rowscale·colscale (S = 6: near f64).

A peel is a call of ``peel_f64`` (the row scales and the slices from the
f64 view) and a product a call of ``mm_groups_f64`` (the grouped slice
products, merged, rescaled and added into the caller's f64 matrix as
``out := beta·out + alpha·A·B``), ops/kernels/ozaki.py: ONE launch each
on a CUDA tensor, with no torch pass around it; on a CPU tensor the
plain twins, the same arithmetic as torch passes, bit for bit.

Each peel is the span ``ozaki.split`` and each product ``ozaki.product``
(``utils/profiling.py``), around the kernel's ``kernel.*`` span.
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
    return _kz.peel_f64(A, slices=slices)


@profiling.annotate_function(
    name="ozaki.product",
    attrs=lambda As, ascale, Bs, bscale, **_: {
        "m": As.shape[1], "n": Bs.shape[1], "k": As.shape[2]})
def matmul_presplit(As, ascale, Bs, bscale, *, out=None, alpha=1.0,
                    beta=0.0):
    """out := beta·out + alpha·C, C ≈ A·B from peeled operands: As (S, m, k)
    with row scales (m,) from ``split_rows(A)``, Bs (S, n, k) with scales
    (n,) from ``split_rows(B.T)``; returns out, or alpha·C in a new tensor
    where out is None (beta 0 then). beta 0 reads nothing of out. The
    grouped slice products are an exact f32 pair (hi, lo), whose ~48 bits
    sit below the 2^(-7S) floor of the dropped pairs, and
    C = ((hi + lo)·ascale_i)·bscale_j; bit for bit the torch passes of
    :func:`~cholesky_tpu_torch.ops.kernels.ozaki.epilogue_plain`. out may
    be a view of A or B: their peels are already taken."""
    S, m, k = As.shape
    S2, n, k2 = Bs.shape
    check(S == S2 and k == k2, "matmul_presplit", 3,
          lambda: f"peels do not match: {tuple(As.shape)} and "
                  f"{tuple(Bs.shape)}")
    if k > K_EXACT_MAX:
        # each chunk keeps the int32 sums exact; the f64 partial products
        # are linear in the scales, so scaling inside each chunk is exact.
        # They are summed in a buffer of their own, then merged into out.
        acc = torch.zeros((m, n), dtype=torch.float64, device=As.device)
        for c in range(0, k, _K_CHUNK):
            matmul_presplit(As[:, :, c:c + _K_CHUNK], ascale,
                            Bs[:, :, c:c + _K_CHUNK], bscale, out=acc,
                            beta=1.0)
        return _kz.update_plain(acc, out, alpha, beta)
    return _kz.mm_groups_f64(As, ascale, Bs, bscale, out=out, alpha=alpha,
                             beta=beta)


def matmul_f64(A, B, *, slices: int = 4, out=None, alpha=1.0, beta=0.0):
    """out := beta·out + alpha·C, C ≈ A·B for f64 operands (any strided
    views) through exact int8 slice products, as :func:`matmul_presplit`
    (out may be a view of A or B); the error of an element of C is about
    K·2^(-7·slices)·rowscale(A)_i·colscale(B)_j. Beyond K_EXACT_MAX the
    contraction is cut into chunks, each peeled with its own scales."""
    check(A.dtype == B.dtype == torch.float64, "matmul_f64", 1,
          lambda: f"float64 operands only, got {A.dtype} and {B.dtype}")
    check(A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0],
          "matmul_f64", 2,
          lambda: f"inner dims {tuple(A.shape)} x {tuple(B.shape)}")
    m, k = A.shape
    n = B.shape[1]
    if k > K_EXACT_MAX:
        nchunks = -(-k // K_EXACT_MAX)
        step = -(-k // nchunks)
        acc = torch.zeros((m, n), dtype=A.dtype, device=A.device)
        for c in range(0, k, step):
            matmul_f64(A[:, c:c + step], B[c:c + step], slices=slices,
                       out=acc, beta=1.0)
        return _kz.update_plain(acc, out, alpha, beta)
    As, ascale = split_rows(A, slices)
    Bs, bscale = split_rows(B.T, slices)
    return matmul_presplit(As, ascale, Bs, bscale, out=out, alpha=alpha,
                           beta=beta)
