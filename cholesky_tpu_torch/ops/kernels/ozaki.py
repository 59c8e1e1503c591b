"""The kernels of the d tier's Ozaki products (ops/ozaki.py), each
beside its plain torch twin:

- peel_f32pair (csrc/ozaki_peel.cu) replaces ``cholesky_tpu/ops/pallas/
  ozaki_split.py:peel_f32pair``: the S int8 slices of an exact f32 pair,
  bit for bit;
- mm_groups_f32pair (csrc/ozaki_mm.cu) replaces ``cholesky_tpu/ops/pallas/
  ozaki_mm.py:mm_groups_f32pair``: all slice products, summed by weight
  group, as an f32 (hi, lo) pair;
- peel_f64 (csrc/ozaki_peel.cu): the row scales and the slices of an f64
  matrix in one launch, bit for bit :func:`scaled_pair` then the peel;
- mm_groups_f64 (csrc/ozaki_mm.cu): mm_groups_f32pair's products with the
  f64 epilogue, the pair merged, rescaled and added into the caller's f64
  matrix in one launch, bit for bit :func:`epilogue_plain` of the pair.

The last two are the d tier's path on the card (ops/ozaki.py); the first
two stay for the hoisted peels' tests and the JAX package's twins. A CPU
tensor takes the plain twin; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check

SLICE_BITS = 7      # bits per slice, as the JAX package's ozaki_mm.SLICE_BITS
MAX_SLICES = 8      # the kernels' limit, and the S of ozaki.K_EXACT_MAX
ALIGN = 16          # bytes: where the kernel's slice rows start on the card


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


def peel_plain(rh, rl, slices: int):
    """The plain torch version, any device: the JAX package's
    round-and-subtract loop, one torch pass per operation, so nothing is
    contracted into an FMA. Returns a contiguous (S, m, k) int8 tensor."""
    outs = []
    for _ in range(slices):
        hb = rh * 128.0
        q = torch.round(hb)                 # half to even, as jnp.round
        outs.append(q.to(torch.int8))
        d = hb - q                          # |d| <= 1/2: exact
        lb = rl * 128.0
        t = d + lb                          # two-sum: new hi ...
        rl = lb - (t - d)                   # ... and its exact error
        rh = t
    return torch.stack(outs)


def _peel_shape(rh, rl, *, slices):
    return {"m": rh.shape[0], "k": rh.shape[1], "slices": slices}


@_build.kernel_span("peel_f32pair", _peel_shape)
def peel_f32pair(rh, rl, *, slices: int):
    """int8 slices (S, m, k) of the exact pair value rh + rl, f32 (m, k)
    strided views already scaled into [-1/2, 1/2]. On the card the result
    is a view of an (S, m, kp) buffer whose rows are padded to a multiple
    of ALIGN bytes, so that its rows, and the rows of any sub-block at a k
    offset that is a multiple of ALIGN, reach :func:`mm_groups_f32pair`'s
    kernel without a copy."""
    check(rh.ndim == 2 and rh.shape == rl.shape, "peel_f32pair", 1,
          f"rh and rl must be 2-D of one shape, got {tuple(rh.shape)} and "
          f"{tuple(rl.shape)}")
    check(rh.dtype == rl.dtype == torch.float32, "peel_f32pair", 1,
          "float32 operands only")
    check(rh.device == rl.device, "peel_f32pair", 2,
          "operands on different devices")
    check(1 <= slices <= MAX_SLICES, "peel_f32pair", 3,
          f"slices={slices} outside 1..{MAX_SLICES}")
    if rh.device.type == "cpu":
        return peel_plain(rh, rl, slices)
    check(rh.device.type == "cuda", "peel_f32pair", 1,
          f"unsupported device {rh.device}")
    m, k = rh.shape
    kp = _padded(k)
    out = torch.empty((slices, m, kp), dtype=torch.int8, device=rh.device)
    if m == 0 or k == 0:
        return out[:, :, :k]
    vec_in = all(t.stride(1) == 1 and t.stride(0) % 4 == 0
                 and t.data_ptr() % 16 == 0 for t in (rh, rl))
    _build.launch(
        "peel_f32pair", rh.data_ptr(), rh.stride(0), rh.stride(1),
        rl.data_ptr(), rl.stride(0), rl.stride(1),
        out.data_ptr(), kp, m * kp, m, k, kp, slices, int(vec_in),
        *_build.device_args(rh))
    peel_f32pair.launches += 1
    return out[:, :, :k]


def _padded(k):
    """k rounded up to ALIGN bytes of int8, at least ALIGN: the row stride
    of a peel on the card."""
    return -(-max(k, 1) // ALIGN) * ALIGN


def peel_f64_plain(A, slices: int):
    """The plain torch version of :func:`peel_f64`, any device:
    :func:`scaled_pair`, then :func:`peel_plain`."""
    rh, rl, scale = scaled_pair(A)
    return peel_plain(rh, rl, slices), scale


def _peel64_shape(A, *, slices):
    return {"m": A.shape[0], "k": A.shape[1], "slices": slices}


@_build.kernel_span("peel_f64", _peel64_shape)
def peel_f64(A, *, slices: int):
    """(slices (S, m, k) int8, row scales (m,) f64) of the f64 matrix A,
    any strided view: bit for bit :func:`peel_f64_plain`, in one launch
    on the card. The slices are laid out as :func:`peel_f32pair`'s (a view
    of an (S, m, kp) buffer, rows padded to ALIGN bytes with zeros). The
    kernel reads rows along the unit stride one warp a row, and rows
    across it (a transposed view) 32 rows a block, chosen by A's
    strides; where those blocks cannot fill the card (few rows, as
    ``B[:n1].T`` of a solve with few right-hand sides), the same launch
    splits k among more blocks."""
    # the messages are formatted only on failure: a d call peels thousands
    # of times
    check(A.ndim == 2 and A.dtype == torch.float64, "peel_f64", 1,
          lambda: f"a 2-D float64 matrix only, got {tuple(A.shape)} "
                  f"{A.dtype}")
    check(1 <= slices <= MAX_SLICES, "peel_f64", 2,
          lambda: f"slices={slices} outside 1..{MAX_SLICES}")
    device = A.device
    if device.type == "cpu":
        return peel_f64_plain(A, slices)
    check(device.type == "cuda", "peel_f64", 1,
          lambda: f"unsupported device {device}")
    m, k = A.shape
    kp = _padded(k)
    buf = torch.empty((slices, m, kp), dtype=torch.int8, device=device)
    out = buf.as_strided((slices, m, k), (m * kp, kp, 1))
    scale = torch.empty((m,), dtype=torch.float64, device=device)
    if m == 0:
        return out, scale
    _build.launch(
        "peel_f64", A.data_ptr(), A.stride(0), A.stride(1), out.data_ptr(),
        kp, m * kp, scale.data_ptr(), m, k, kp, slices,
        *_build.device_args(A))
    peel_f64.launches += 1
    return out, scale


def _check_groups(As, Bs, name="mm_groups_f32pair"):
    check(As.ndim == 3 and Bs.ndim == 3, name, 1,
          "As and Bs must be (S, rows, k)")
    S, m, k = As.shape
    check(Bs.shape[0] == S and Bs.shape[2] == k, name, 2,
          lambda: f"slices/k mismatch: {tuple(As.shape)} and "
                  f"{tuple(Bs.shape)}")
    check(As.dtype == Bs.dtype == torch.int8, name, 1, "int8 slices only")
    check(As.device == Bs.device, name, 2, "operands on different devices")
    check(1 <= S <= MAX_SLICES, name, 1,
          lambda: f"S={S} outside 1..{MAX_SLICES}")
    return S, m, Bs.shape[1], k


def mm_groups_plain(As, Bs):
    """The plain torch version, any device: each group sum G_g as exact f64
    products of the int8 values (exact below 2^53), x = sum_g 2^(-7(g+2))
    G_g in f64, returned as hi = f32(x), lo = f32(x - hi)."""
    S, m, n, _ = _check_groups(As, Bs)
    A64, B64 = As.double(), Bs.double()
    x = torch.zeros((m, n), dtype=torch.float64, device=As.device)
    for g in range(S):
        G = sum(A64[s] @ B64[g - s].T for s in range(g + 1))
        x += G * 2.0 ** (-SLICE_BITS * (g + 2))
    hi = x.float()
    return hi, (x - hi.double()).float()


def aligned_rows(X):
    """X itself when its k axis is unit-stride and every slice row starts
    on an ALIGN-byte boundary (the kernel's 16-byte copies need both), else
    X copied by one ``copy_`` into a new (S, rows, kp) buffer, kp the k
    extent rounded up to ALIGN, and viewed back to (S, rows, k): a
    sub-block of a peel at any k offset, a transposed view. The kernel
    zero-fills past k itself and never reads the pad."""
    S, rows, k = X.shape
    if ((X.stride(2) == 1 or k <= 1) and X.data_ptr() % ALIGN == 0
            and X.stride(0) % ALIGN == 0 and X.stride(1) % ALIGN == 0):
        return X
    buf = X.new_empty((S, rows, _padded(k)))
    buf[:, :, :k].copy_(X)
    return buf[:, :, :k]


def _groups_shape(As, Bs):
    return {"slices": As.shape[0], "m": As.shape[1], "n": Bs.shape[1],
            "k": As.shape[2]}


@_build.kernel_span("mm_groups_f32pair", _groups_shape)
def mm_groups_f32pair(As, Bs):
    """Group-weighted slice-product sum of As (S, m, k) and Bs (S, n, k),
    int8, as an f32 pair (hi, lo), (m, n) each:
    hi + lo = sum_g 2^(-7(g+2)) sum_{s+t=g} As[s]·Bs[t]ᵀ, g < S. Both may
    be any strided views; on the card one whose rows do not start on
    ALIGN-byte boundaries with a unit k stride (a sub-block of a peel at a
    k offset that is not a multiple of ALIGN) is first copied into an
    aligned buffer (:func:`aligned_rows`)."""
    S, m, n, k = _check_groups(As, Bs)
    if As.device.type == "cpu":
        return mm_groups_plain(As, Bs)
    check(As.device.type == "cuda", "mm_groups_f32pair", 1,
          f"unsupported device {As.device}")
    As, Bs = aligned_rows(As), aligned_rows(Bs)
    hi = torch.empty((m, n), dtype=torch.float32, device=As.device)
    lo = torch.empty_like(hi)
    if m == 0 or n == 0:
        return hi, lo
    _build.launch(
        "mm_groups_f32pair", As.data_ptr(), As.stride(0), As.stride(1),
        Bs.data_ptr(), Bs.stride(0), Bs.stride(1),
        hi.data_ptr(), lo.data_ptr(), n, S, m, n, k,
        *_build.device_args(As))
    mm_groups_f32pair.launches += 1
    return hi, lo


def update_plain(P, out=None, alpha=1.0, beta=0.0):
    """out := beta·out + alpha·P in torch passes, P a new f64 tensor the
    caller gives up: alpha·P first, then its sum with beta·out (beta 0
    reads nothing of out, beta 1 multiplies by nothing), as the d tier's
    callers composed it (``B -= P`` is ``B + (−1·P)`` bit for bit).
    Returns out, or alpha·P where out is None."""
    if alpha != 1.0:
        P = P.mul_(alpha)
    if out is None:
        return P
    if beta == 0.0:
        return out.copy_(P)
    if beta != 1.0:
        out.mul_(beta)
    return out.add_(P)


def epilogue_plain(hi, lo, ascale, bscale, out=None, alpha=1.0, beta=0.0):
    """The f64 epilogue of an Ozaki product in torch passes, the plain
    version of mm_groups_f64's: P = ((hi + lo)·ascale_i)·bscale_j in f64,
    then :func:`update_plain`."""
    P = (hi.double() + lo.double()) * ascale[:, None] * bscale[None, :]
    return update_plain(P, out, alpha, beta)


def _groups64_shape(As, ascale, Bs, bscale, *, out=None, alpha=1.0,
                    beta=0.0):
    return {**_groups_shape(As, Bs), "c_read": out is not None
            and beta != 0.0}


@_build.kernel_span("mm_groups_f64", _groups64_shape)
def mm_groups_f64(As, ascale, Bs, bscale, *, out=None, alpha=1.0, beta=0.0):
    """out := beta·out + alpha·((hi + lo)·ascale_i)·bscale_j, with (hi, lo)
    :func:`mm_groups_f32pair` of As (S, m, k) and Bs (S, n, k) and the f64
    row scales ascale (m,) and bscale (n,) of their peels: bit for bit
    :func:`epilogue_plain` of the pair, in one launch on the card. out is
    an (m, n) f64 view whose elements do not overlap, or None for a new
    one (beta 0 then); beta 0 reads nothing of out. Returns out. The
    operands' rows are aligned as :func:`mm_groups_f32pair`'s."""
    S, m, n, k = _check_groups(As, Bs, "mm_groups_f64")
    device = As.device
    check(ascale.shape == (m,) and bscale.shape == (n,)
          and ascale.dtype == bscale.dtype == torch.float64, "mm_groups_f64",
          3, lambda: f"scales must be float64 ({m},) and ({n},), got "
                     f"{tuple(ascale.shape)} and {tuple(bscale.shape)}")
    check(out is not None or beta == 0.0, "mm_groups_f64", 4,
          "beta needs an out to read")
    if out is not None:
        check(out.shape == (m, n) and out.dtype == torch.float64
              and out.device == device, "mm_groups_f64", 4,
              lambda: f"out must be float64 ({m}, {n}) on {device}")
    if device.type == "cpu":
        return epilogue_plain(*mm_groups_plain(As, Bs), ascale, bscale, out,
                              alpha, beta)
    check(device.type == "cuda", "mm_groups_f64", 1,
          lambda: f"unsupported device {device}")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float64, device=device)
    check(_build.writable_2d(out), "mm_groups_f64", 4,
          "out's elements overlap")
    if m == 0 or n == 0:
        return out
    As, Bs = aligned_rows(As), aligned_rows(Bs)
    ascale, bscale = ascale.contiguous(), bscale.contiguous()
    _build.launch(
        "mm_groups_f64", As.data_ptr(), As.stride(0), As.stride(1),
        Bs.data_ptr(), Bs.stride(0), Bs.stride(1), ascale.data_ptr(),
        bscale.data_ptr(), out.data_ptr(), out.stride(0), out.stride(1),
        float(alpha), float(beta), S, m, n, k, *_build.device_args(As))
    mm_groups_f64.launches += 1
    return out


peel_f32pair.launches = 0
mm_groups_f32pair.launches = 0
peel_f64.launches = 0
mm_groups_f64.launches = 0
